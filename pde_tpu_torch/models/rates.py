"""Interest-rate models (twin of ``pde_tpu/models/rates.py``): discount
curves, Vasicek/CIR affine bonds, the Hull-White (extended-Vasicek)
short-rate model with closed-form bond options, caps/floors and Jamshidian
swaptions, Bachelier and Black-76 quoting, and the caplet-vol strip.

* A :class:`DiscountCurve` is a pair of tensors ``(times, dfs)`` read by
  log-linear interpolation (piecewise-constant forwards): the reference's
  ``jnp.interp`` rule built from ``torch.searchsorted``, so a curve read
  runs under ``torch.func.jacfwd``/``vmap`` (the curve is data, never a
  parameter of a fit).
* Every pricer is a closed-form tensor expression that broadcasts over its
  quote arguments.  The swap-based names (:func:`hw_swap_rate`,
  :func:`hw_swaption`) take pay dates on a trailing axis and broadcast over
  leading ones: a panel of swaptions (expiries ``(...,)``, pay dates
  ``(..., n)``) prices in one call, the port's form of the reference's
  ``vmap`` over expiries.
* Every Newton loop keeps the reference's fixed trip count, reads nothing
  back to the host and takes its derivative in closed form
  (d/dr sum c_i P_i(r) = -sum c_i B_i P_i; the Black and Bachelier vegas).
  The Jamshidian rate carries derivatives in its inputs through its last
  trip only (:func:`_jamshidian_rate`).
* :func:`hw_simulate` draws Philox normals from a ``torch.Generator`` on
  the path's device and hands them to :func:`_hw_simulate_core`, which
  takes the normals (the tests feed it JAX's own draws).

Functions follow their inputs' device (a curve's tensors, else the card).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core.precision import device_of, result_dtype, to_tensor, where_flag
from ..utils.stats import norm_cdf, norm_pdf
from .ou import _normals

__all__ = [
    "DiscountCurve",
    "VasicekParams",
    "CIRParams",
    "HullWhiteParams",
    "flat_curve",
    "curve_from_zero_rates",
    "vasicek_bond",
    "vasicek_bond_option",
    "cir_bond",
    "hw_bond",
    "hw_bond_option",
    "hw_caplet",
    "hw_floorlet",
    "hw_cap",
    "hw_swap_rate",
    "hw_swaption",
    "hw_alpha",
    "hw_simulate",
    "bachelier_price",
    "bachelier_implied_vol",
    "black_caplet_price",
    "black_cap_price",
    "strip_caplet_vols",
]


def _tensors(*xs, device=None):
    """``xs`` as tensors of one floating dtype on one device (the first
    tensor's, else ``device``, else the card)."""
    dtype = result_dtype(*xs)
    dev = device_of(*xs, default=device)
    return tuple(to_tensor(x, dtype, dev) for x in xs)


def _on(curve, *xs):
    """``xs`` as tensors on ``curve``'s device, in the dtype of the curve
    and the tensors among them."""
    dtype = result_dtype(curve.dfs, *xs)
    return tuple(to_tensor(x, dtype, curve.dfs.device) for x in xs)


def _host_floats(x):
    """A schedule (numbers, array or tensor) as Python floats: read once on
    the host, as the reference reads its grids through numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return tuple(float(v) for v in np.atleast_1d(np.asarray(x, dtype=np.float64)))


def _linspace(start, stop, num: int, dtype, device):
    """``jnp.linspace`` (endpoint included) to an ulp: start (1 - s) +
    stop s with s = k / (num - 1), and ``stop`` itself last."""
    div = num - 1
    s = torch.arange(div, dtype=dtype, device=device) / div
    start, stop = (to_tensor(v, dtype, device) for v in (start, stop))
    return torch.cat([start * (1 - s) + stop * s, stop.reshape(1)])


def _broadcast_schedule(start, pay_times):
    """Leading axes of a start ``(...,)`` and its pay dates ``(..., n)``
    broadcast together."""
    lead = torch.broadcast_shapes(start.shape, pay_times.shape[:-1])
    return start.expand(lead), pay_times.expand(*lead, pay_times.shape[-1])


# ---------------------------------------------------------------------------
# discount curve


class _Reads(NamedTuple):
    """Where reads at ``t`` fall on the pillars (0, times): the reference's
    ``jnp.interp`` index and weight, and the masks of its clamp below 0 and
    of the flat-forward extrapolation past the last pillar."""

    i: torch.Tensor
    w: torch.Tensor
    below: torch.Tensor
    beyond: torch.Tensor
    past: torch.Tensor        # t - times[-1]
    last_dx: torch.Tensor     # times[-1] - times[-2] (the implicit 0 included)


def _plan_reads(times, t) -> _Reads:
    t = to_tensor(t, result_dtype(t, times), times.device)
    xp = torch.cat([torch.zeros(1, dtype=t.dtype, device=t.device), times.to(t.dtype)])
    i = torch.searchsorted(xp, t.contiguous(), right=True).clamp(1, xp.shape[0] - 1)
    w = (t - xp[i - 1]) / (xp[i] - xp[i - 1])
    return _Reads(i, w, t < xp[0], t > xp[-1], t - xp[-1], xp[-1] - xp[-2])


def _read_logs(reads: _Reads, logs):
    """The log-linear read of pillar values ``logs`` (the implicit 0 at
    t = 0 prepended), extrapolated flat-forward with the last segment's
    slope: linear in ``logs``."""
    fp = torch.cat([torch.zeros(1, dtype=logs.dtype, device=logs.device), logs])
    fp = fp.to(reads.w.dtype)
    inside = fp[reads.i - 1] + reads.w * (fp[reads.i] - fp[reads.i - 1])
    inside = torch.where(reads.below, fp[0], inside)
    slope_end = (fp[-1] - fp[-2]) / reads.last_dx
    return torch.where(reads.beyond, fp[-1] + slope_end * reads.past, inside)


class DiscountCurve(NamedTuple):
    """Market discount curve: ``dfs[i] = P(0, times[i])``.

    ``times`` must be strictly increasing and positive; ``P(0, 0) = 1`` is
    implicit.  Interpolation is linear in ``log P`` (piecewise-constant
    forward rates), flat-forward extrapolated beyond the last pillar.
    """

    times: torch.Tensor
    dfs: torch.Tensor

    def _log_df(self, t):
        return _read_logs(_plan_reads(self.times, t), torch.log(self.dfs))

    def df(self, t):
        """P(0, t): broadcasts over ``t``."""
        return torch.exp(self._log_df(t))

    def zero_rate(self, t):
        """Continuously-compounded zero rate: ``-log P(0,t) / t``."""
        t, = _on(self, t)
        return -torch.log(self.df(t)) / torch.where(t > 0, t, 1.0)

    def forward(self, t1, t2):
        """Simply-compounded forward rate over ``[t1, t2]``."""
        t1, t2 = _on(self, t1, t2)
        return (self.df(t1) / self.df(t2) - 1.0) / (t2 - t1)

    def inst_forward(self, t, eps: float = 1e-5):
        """Instantaneous forward ``f(0, t) = -d log P / dt`` by a symmetric
        difference, exact in the interior of each flat-forward segment."""
        t, = _on(self, t)
        lo = torch.clamp_min(t - eps, 0.0)
        return (self._log_df(lo) - self._log_df(t + eps)) / (t + eps - lo)


def flat_curve(rate, horizon: float = 50.0, n: int = 2, dtype=None, device=None):
    """Constant-rate curve ``P(0,t) = e^{-rate t}`` on the rate's device
    (the card for a plain number, unless ``device`` names another)."""
    dt = dtype or result_dtype(rate)
    dev = device_of(rate, default=device)
    times = _linspace(horizon / n, horizon, n, dt, dev)
    return DiscountCurve(times, torch.exp(-to_tensor(rate, dt, dev) * times))


def curve_from_zero_rates(times, zero_rates, device=None):
    """Curve from continuously-compounded zero rates at pillar times."""
    times, zr = _tensors(times, zero_rates, device=device)
    return DiscountCurve(times, torch.exp(-zr * times))


# ---------------------------------------------------------------------------
# Vasicek: dr = kappa (theta - r) dt + sigma dW


class VasicekParams(NamedTuple):
    kappa: torch.Tensor
    theta: torch.Tensor
    sigma: torch.Tensor
    r0: torch.Tensor

    def validate(self):
        if float(self.kappa) <= 0:
            raise ValueError("kappa must be positive")
        if float(self.sigma) <= 0:
            raise ValueError("sigma must be positive")
        return self


def _affine_b(a, tau):
    """B(tau) = (1 - e^{-a tau}) / a, with the a -> 0 limit tau."""
    a, tau = _tensors(a, tau)
    small = torch.abs(a) < 1e-12
    a_safe = torch.where(small, 1.0, a)
    return torch.where(small, tau, -torch.expm1(-a_safe * tau) / a_safe)


def vasicek_bond(params: VasicekParams, maturity, t=0.0, r=None):
    """P(t, T) = A e^{-B r} under Vasicek (affine closed form)."""
    r = params.r0 if r is None else r
    T, t, r, k, th, sig = _tensors(maturity, t, r, params.kappa, params.theta, params.sigma)
    tau = T - t
    B = _affine_b(k, tau)
    lnA = (th - sig * sig / (2.0 * k * k)) * (B - tau) - sig * sig * B * B / (4.0 * k)
    return torch.exp(lnA - B * r)


def vasicek_bond_option(params: VasicekParams, strike, expiry, bond_maturity, is_call=True):
    """European option (expiry ``T0``) on a ZCB maturing at ``T1 > T0``:
    the Jamshidian (1989) closed form, lognormal bond-price dynamics."""
    T0, T1, k, sig = _tensors(expiry, bond_maturity, params.kappa, params.sigma)
    p0 = vasicek_bond(params, T0)
    p1 = vasicek_bond(params, T1)
    sig_p = sig * _affine_b(k, T1 - T0) * torch.sqrt(-torch.expm1(-2.0 * k * T0) / (2.0 * k))
    return _zcb_option_black(p0, p1, strike, sig_p, is_call)


def _zcb_option_black(df_expiry, df_bond, strike, sig_p, is_call):
    """Black-style ZCB option kernel shared by Vasicek and Hull-White:
    price = P1 N(h) - K P0 N(h - sig_p) (call), with put by parity."""
    sig_p = torch.clamp_min(sig_p, 1e-12)
    h = torch.log(df_bond / (df_expiry * strike)) / sig_p + 0.5 * sig_p
    call = df_bond * norm_cdf(h) - strike * df_expiry * norm_cdf(h - sig_p)
    return where_flag(is_call, call, call - df_bond + strike * df_expiry)


# ---------------------------------------------------------------------------
# CIR: dr = kappa (theta - r) dt + sigma sqrt(r) dW


class CIRParams(NamedTuple):
    kappa: torch.Tensor
    theta: torch.Tensor
    sigma: torch.Tensor
    r0: torch.Tensor

    def feller(self) -> bool:
        return float(2.0 * self.kappa * self.theta) > float(self.sigma ** 2)


def cir_bond(params: CIRParams, maturity, t=0.0, r=None):
    """P(t, T) under CIR (Cox-Ingersoll-Ross 1985 closed form)."""
    r = params.r0 if r is None else r
    T, t, r, k, th, sig = _tensors(maturity, t, r, params.kappa, params.theta, params.sigma)
    tau = T - t
    g = torch.sqrt(k * k + 2.0 * sig * sig)
    # the form in e^{-g tau}: the textbook (e^{g tau} - 1) expressions
    # overflow for stiff kappa (g tau >~ 700)
    em = -torch.expm1(-g * tau)  # 1 - e^{-g tau}
    denom = (g + k) * em / 2.0 + g * torch.exp(-g * tau)
    B = em / denom
    lnA = (2.0 * k * th / (sig * sig)) * (torch.log(g) + 0.5 * (k - g) * tau - torch.log(denom))
    return torch.exp(lnA - B * r)


# ---------------------------------------------------------------------------
# Hull-White: dr = (theta(t) - a r) dt + sigma dW, fitted to the input curve


class HullWhiteParams(NamedTuple):
    """Hull-White one-factor with the market :class:`DiscountCurve`
    embedded: the model reproduces ``curve.df(T)`` for every T by
    construction, so calibration only fits ``(a, sigma)``."""

    a: torch.Tensor
    sigma: torch.Tensor
    curve: DiscountCurve

    def validate(self):
        if float(self.a) <= 0:
            raise ValueError("mean reversion a must be positive")
        if float(self.sigma) <= 0:
            raise ValueError("sigma must be positive")
        return self


def _hw_affine(params: HullWhiteParams, maturity, t):
    """``(ln A, B)`` of P(t, T | r) = A e^{-B r}, reconstructed from the
    market curve (broadcast over ``maturity`` and ``t``)."""
    curve = params.curve
    T, t, a, sig = _on(curve, maturity, t, params.a, params.sigma)
    B = _affine_b(a, T - t)
    f0t = curve.inst_forward(t)
    lnA = (torch.log(curve.df(T) / curve.df(t)) + B * f0t
           - sig * sig / (4.0 * a) * -torch.expm1(-2.0 * a * t) * B * B)
    return lnA, B


def hw_bond(params: HullWhiteParams, maturity, t=0.0, r=None):
    """P(t, T | r_t), the Hull-White affine reconstruction from the market
    curve.  At ``t = 0`` (``r = None``) it returns ``curve.df(T)`` exactly."""
    if r is None:
        return params.curve.df(maturity)
    lnA, B = _hw_affine(params, maturity, t)
    return torch.exp(lnA - B * r)


def hw_bond_option(params: HullWhiteParams, strike, expiry, bond_maturity, is_call=True):
    """European ZCB option under Hull-White: Black kernel with

        sig_p = sigma B(T0, T1) sqrt((1 - e^{-2 a T0}) / (2a)).
    """
    curve = params.curve
    T0, T1, a, sig = _on(curve, expiry, bond_maturity, params.a, params.sigma)
    sig_p = sig * _affine_b(a, T1 - T0) * torch.sqrt(-torch.expm1(-2.0 * a * T0) / (2.0 * a))
    return _zcb_option_black(curve.df(T0), curve.df(T1), strike, sig_p, is_call)


def hw_caplet(params: HullWhiteParams, strike_rate, start, end, notional=1.0):
    """Caplet on the simple forward over ``[start, end]``, settled at
    ``end``: ``(1 + tau K)`` puts on the ZCB P(start, end) struck at
    ``1 / (1 + tau K)`` (standard static replication)."""
    start, end, k = _on(params.curve, start, end, strike_rate)
    tau = end - start
    put = hw_bond_option(params, 1.0 / (1.0 + tau * k), start, end, is_call=False)
    return notional * (1.0 + tau * k) * put


def hw_floorlet(params: HullWhiteParams, strike_rate, start, end, notional=1.0):
    start, end, k = _on(params.curve, start, end, strike_rate)
    tau = end - start
    call = hw_bond_option(params, 1.0 / (1.0 + tau * k), start, end, is_call=True)
    return notional * (1.0 + tau * k) * call


def hw_cap(params: HullWhiteParams, strike_rate, pay_times, notional=1.0):
    """Cap = strip of caplets over consecutive ``pay_times`` (the first
    element is the start of the first accrual; no caplet pays on it)."""
    pt, = _on(params.curve, pay_times)
    return torch.sum(hw_caplet(params, strike_rate, pt[..., :-1], pt[..., 1:], notional), dim=-1)


def hw_swap_rate(curve: DiscountCurve, start, pay_times):
    """Par swap rate for a swap starting at ``start`` paying the fixed leg
    at ``pay_times`` (annuity-weighted forward).  Pay dates on the last
    axis; leading axes broadcast with ``start``."""
    start, pt = _broadcast_schedule(*_on(curve, start, pay_times))
    taus = torch.diff(pt, dim=-1, prepend=start[..., None])
    annuity = torch.sum(taus * curve.df(pt), dim=-1)
    return (curve.df(start) - curve.df(pt[..., -1])) / annuity


def _jamshidian_rate(lnA, B, coupons, n_newton: int):
    """The r solving sum_i c_i A_i e^{-B_i r} = 1 over the last axis:
    fixed-trip Newton from 0 with the closed-form derivative
    -sum_i c_i B_i A_i e^{-B_i r}.

    All trips but the last run on detached values; the last carries the
    derivative in the inputs.  The value is the same n-th iterate, and at
    the root one Newton step's derivative is the implicit-function one,
    which the reference's derivative through every trip converges to
    (quadratically): the LM's ``jacfwd`` then pushes its tangents through
    one trip, not thirty."""
    def trip(r, lnA, B, coupons):
        p = coupons * torch.exp(lnA - B * r[..., None])
        return r - (torch.sum(p, dim=-1) - 1.0) / -torch.sum(B * p, dim=-1)

    r = torch.zeros(lnA.shape[:-1], dtype=lnA.dtype, device=lnA.device)
    held = tuple(v.detach() for v in (lnA, B, coupons))
    for _ in range(n_newton - 1):
        r = trip(r, *held)
    return trip(r, lnA, B, coupons) if n_newton > 0 else r


def _hw_critical_rate(params, expiry, pay_times, coupons, n_newton: int = 30):
    """Jamshidian critical short rate r*: coupon bond price at expiry = 1.

    Fixed-trip Newton (the bond price is monotone decreasing and convex in
    r, so Newton from 0 converges quadratically; 30 trips is far past
    float64 convergence).  ``expiry`` ``(...,)``, pay dates and coupons
    ``(..., n)``."""
    expiry, = _on(params.curve, expiry)
    lnA, B = _hw_affine(params, pay_times, expiry[..., None])
    return _jamshidian_rate(lnA, B, coupons, n_newton)


def hw_swaption(params: HullWhiteParams, strike_rate, expiry, pay_times,
                notional=1.0, payer=True, n_newton: int = 30):
    """European swaption via the Jamshidian (1989) decomposition.

    A payer swaption (right to pay fixed ``K``) is a put on the coupon bond
    with coupons ``tau_i K`` (+1 at the final date) struck at par; in a
    one-factor model the coupon-bond option decomposes exactly into ZCB
    options struck at each bond's value at the critical rate ``r*``.
    Pay dates on the last axis; ``expiry`` and ``strike_rate`` broadcast
    over the leading ones (a panel of swaptions in one call).
    """
    expiry, pt, k = _on(params.curve, expiry, pay_times, strike_rate)
    expiry, k = torch.broadcast_tensors(expiry, k)
    expiry, pt = _broadcast_schedule(expiry, pt)
    k = k.expand(expiry.shape)
    taus = torch.diff(pt, dim=-1, prepend=expiry[..., None])
    coupons = taus * k[..., None]
    coupons = torch.cat([coupons[..., :-1], coupons[..., -1:] + 1.0], dim=-1)
    lnA, B = _hw_affine(params, pt, expiry[..., None])
    r_star = _jamshidian_rate(lnA, B, coupons, n_newton)
    strikes = torch.exp(lnA - B * r_star[..., None])  # K_i = P(T0, T_i; r*)
    # payer swaption = sum_i c_i ZCB-put(K_i); receiver = calls
    opts = hw_bond_option(params, strikes, expiry[..., None], pt, is_call=not payer)
    return notional * torch.sum(coupons * opts, dim=-1)


# ---------------------------------------------------------------------------
# simulation


def hw_alpha(params: HullWhiteParams, t):
    """Deterministic shift alpha(t) = f(0,t) + sigma^2/(2a^2) (1-e^{-at})^2
    with r(t) = x(t) + alpha(t), x an OU(0) factor."""
    t, a, sig = _on(params.curve, t, params.a, params.sigma)
    one = -torch.expm1(-a * t)
    return params.curve.inst_forward(t) + sig * sig / (2.0 * a * a) * one * one


def _hw_simulate_core(a, sig, alphas, dt, z):
    """The exact OU transition of x on the normals ``z`` (n_steps, n_paths)
    and the trapezoid of r = x + alpha: ``(r_path, int_r)``, ``alphas`` of
    length n_steps + 1."""
    e = torch.exp(-a * dt)
    sd = sig * torch.sqrt(-torch.expm1(-2.0 * a * dt) / (2.0 * a))
    x = torch.zeros(z.shape[1:], dtype=z.dtype, device=z.device)
    integ = torch.zeros_like(x)
    r_path = []
    for k, zk in enumerate(z.unbind(0)):
        x_new = x * e + sd * zk
        # trapezoid on r = x + alpha across the step
        integ = integ + 0.5 * ((x + alphas[k]) + (x_new + alphas[k + 1])) * dt
        r_path.append(x_new + alphas[k + 1])
        x = x_new
    return torch.stack(r_path), integ


def hw_simulate(params: HullWhiteParams, maturity, generator: torch.Generator, *,
                n_steps: int = 64, n_paths: int = 65536):
    """Exact-transition short-rate paths and the integrated rate, on the
    curve's device, from ``generator`` (which must live there).

    Returns ``(r_path, int_r)`` with ``r_path`` of shape ``(n_steps,
    n_paths)`` and ``int_r`` the per-path trapezoid of ``int_0^T r dt``:
    ``E[e^{-int_r}]`` reproduces ``curve.df(T)`` to MC and trapezoid error.
    Philox and threefry streams differ, so the paths match the reference
    only on the same normals (:func:`_hw_simulate_core`).
    """
    T, a, sig = _on(params.curve, maturity, params.a, params.sigma)
    dt = T / n_steps
    ts = _linspace(0.0, T, n_steps + 1, T.dtype, T.device)
    z = _normals(generator, (n_steps, n_paths), T.dtype, T.device)
    return _hw_simulate_core(a, sig, hw_alpha(params, ts), dt, z)


# ---------------------------------------------------------------------------
# Bachelier (normal) quoting: the swaption market's vol convention


def bachelier_price(forward, strike, vol_n, expiry, annuity=1.0, is_call=True):
    """Bachelier (normal) option price on a forward:

        annuity * [ (F - K) Phi(d) + vol_n sqrt(T) phi(d) ],
        d = (F - K) / (vol_n sqrt(T))

    (the payer-swaption quoting model, annuity = sum tau_i P(0, t_i)).
    Puts (receivers) by parity.  Broadcasts over all arguments.
    """
    f, k, v, T = _tensors(forward, strike, vol_n, expiry)
    sq = torch.clamp_min(v * torch.sqrt(T), 1e-12)
    d = (f - k) / sq
    call = (f - k) * norm_cdf(d) + sq * norm_pdf(d)
    return annuity * where_flag(is_call, call, call - (f - k))


def bachelier_implied_vol(price, forward, strike, expiry, annuity=1.0, is_call=True,
                          n_newton: int = 30):
    """Invert Bachelier to a normal vol: vega is strictly positive, so a
    fixed-trip safeguarded Newton from the Brenner-Subrahmanyam ATM seed
    converges for any arbitrage-free price.  Autograd- and vmap-safe."""
    p, f, k, T = _tensors(price, forward, strike, expiry)
    p = p / annuity
    sqT = torch.sqrt(T)
    intrinsic = where_flag(is_call, torch.clamp_min(f - k, 0.0), torch.clamp_min(k - f, 0.0))
    time_val = torch.clamp_min(p - intrinsic, 1e-16)
    # ATM seed: price = vol sqrt(T) / sqrt(2 pi); away from ATM the
    # straddle-consistent seed still lands in the basin
    v = (time_val + 0.5 * torch.abs(f - k)) * math.sqrt(2.0 * math.pi) / sqT
    for _ in range(n_newton):
        sq = torch.clamp_min(v * sqT, 1e-14)
        d = (f - k) / sq
        call = (f - k) * norm_cdf(d) + sq * norm_pdf(d)
        model = where_flag(is_call, call, call - (f - k))
        vega = sqT * norm_pdf(d)
        v = torch.clamp(v - (model - p) / torch.clamp_min(vega, 1e-14), 1e-10, 10.0)
    return v


# ---------------------------------------------------------------------------
# Black-76 (lognormal) quoting and the caplet vol strip: the cap market's
# vol convention.  The strip closes the quote-to-calibration loop: flat cap
# vols -> forward caplet vols -> caplet prices -> HullWhiteCalibrator.


def _black_caplet(curve: DiscountCurve, strike_rate, start, end, vol, notional=1.0):
    """Black-76 caplet price and its vega d price / d vol."""
    start, end, k, v = _on(curve, start, end, strike_rate, vol)
    f = curve.forward(start, end)
    scale = notional * (end - start) * curve.df(end)
    sq_raw = v * torch.sqrt(start)
    sq = torch.clamp_min(sq_raw, 1e-12)
    d1 = (torch.log(torch.clamp_min(f, 1e-12) / torch.clamp_min(k, 1e-12)) + 0.5 * sq * sq) / sq
    d2 = d1 - sq
    price = scale * (f * norm_cdf(d1) - k * norm_cdf(d2))
    # d d1 / d sq = 1 - d1 / sq, d d2 / d sq = -d1 / sq; sq moves with the
    # vol only above its floor
    dd1 = 1.0 - d1 / sq
    vega = scale * (f * norm_pdf(d1) * dd1 + k * norm_pdf(d2) * (d1 / sq))
    vega = torch.where(sq_raw > 1e-12, vega * torch.sqrt(start), 0.0)
    return price, vega


def black_caplet_price(curve: DiscountCurve, strike_rate, start, end, vol, notional=1.0):
    """Black-76 caplet: the rate fixes at ``start``, pays at ``end``.

        tau P(0, end) [ F Phi(d1) - K Phi(d2) ],
        d1 = (ln(F/K) + v^2 start / 2) / (v sqrt(start))

    with F the simple forward over [start, end].  Broadcasts over all
    arguments.
    """
    return _black_caplet(curve, strike_rate, start, end, vol, notional)[0]


def black_cap_price(curve: DiscountCurve, strike_rate, maturity, vol, freq: float = 0.25,
                    notional=1.0, first_reset=None):
    """Cap = caplet strip at ONE flat Black vol (the market quote).

    Resets every ``freq`` years from ``first_reset`` (default ``freq``: the
    spot-starting convention skips the already-fixed first period) to
    ``maturity``; the schedule is read on the host.
    """
    m = _host_floats(maturity)[0]
    f0 = float(freq if first_reset is None else _host_floats(first_reset)[0])
    starts, = _on(curve, np.arange(f0, m - 1e-9, float(freq)))
    return torch.sum(black_caplet_price(curve, strike_rate, starts, starts + float(freq), vol,
                                        notional))


def strip_caplet_vols(curve: DiscountCurve, strike_rate, cap_maturities, flat_vols,
                      freq: float = 0.25, n_newton: int = 20):
    """Bootstrap FORWARD caplet vols from flat cap vols.

    Market caps quote one flat Black vol per maturity; consistent caplet
    pricing needs the forward vol term structure.  Standard strip: for each
    successive cap, the caplets added since the previous maturity share one
    forward vol, solved by a fixed-trip safeguarded Newton on the Black
    vega so that the strip reprices the cap at its flat vol exactly.

    Returns ``(starts, ends, fwd_vols)``: per-caplet reset schedule and
    forward vols, ready for :func:`black_caplet_price` and
    ``HullWhiteCalibrator.calibrate_caplets``.  Cap maturities are read on
    the host; strike, vols and curve may carry gradients.
    """
    mats = _host_floats(cap_maturities)
    freq = float(freq)
    k, flat_vols = _on(curve, strike_rate, flat_vols)
    starts_np = np.arange(freq, mats[-1] - 1e-9, freq)
    starts, = _on(curve, starts_np)
    ends = starts + freq

    def strip_price(v, mask):
        price, vega = _black_caplet(curve, k, starts, ends, v)
        return torch.sum(torch.where(mask, price, 0.0)), torch.sum(torch.where(mask, vega, 0.0))

    def on_device(mask_np):
        return torch.as_tensor(mask_np, device=starts.device)

    # cap prices at their quoted flat vols: the strip's targets
    caps = [strip_price(flat_vols[i], on_device(starts_np < m - 1e-9))[0]
            for i, m in enumerate(mats)]
    fwd_vols = torch.zeros_like(starts)
    prev_m, prev_strip = 0.0, torch.zeros((), dtype=starts.dtype, device=starts.device)
    for i, m in enumerate(mats):
        new = on_device((starts_np >= prev_m - 1e-9) & (starts_np < m - 1e-9))
        target = caps[i] - prev_strip     # value the NEW caplets must add
        v = flat_vols[i]                  # the flat vol is the natural seed
        for _ in range(n_newton):
            price, vega = strip_price(v, new)
            v = torch.clamp(v - (price - target) / torch.clamp_min(vega, 1e-12), 1e-4, 5.0)
        fwd_vols = torch.where(new, v, fwd_vols)
        prev_strip = prev_strip + strip_price(v, new)[0]
        prev_m = m
    return starts, ends, fwd_vols
