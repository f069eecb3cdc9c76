"""G2++ two-factor Gaussian short-rate model (twin of
``pde_tpu/models/g2.py``).

``r(t) = x(t) + y(t) + phi(t)`` with two correlated constant-coefficient
OU factors

    dx = -a x dt + sigma dW1,   dy = -b y dt + eta dW2,
    d<W1, W2> = rho dt,         x(0) = y(0) = 0,

and ``phi`` fitted so that the model reproduces the input discount curve
exactly (Brigo-Mercurio ch. 4 for every closed form below).

* Bonds, ZCB options (the lognormal Black kernel shared with Hull-White),
  caplets and caps by static replication.
* European swaptions by the Brigo-Mercurio one-dimensional reduction:
  Gauss-Hermite nodes (``numpy.polynomial.hermite_e``, as the reference's)
  over the first factor under the T0-forward measure, a fixed-trip Newton
  for the critical boundary ``ybar(x)`` at every node at once (its
  derivative in closed form, derivatives in the inputs carried by the last
  trip only, as ``rates._jamshidian_rate``'s), then one expression per
  node.  Pay dates sit
  on the last axis and the leading axes broadcast: a panel of swaptions is
  one call, the port's form of the reference's ``vmap`` over expiries.
* Exact joint increment moments of ``(x, y, int (x+y))``, so the Monte
  Carlo steps date to date with no discretization bias;
  :func:`g2_simulate` draws Philox normals from a ``torch.Generator`` and
  hands them to :func:`_g2_simulate_core`, which takes the normals.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..utils.stats import norm_cdf
from .ou import _normals
from .rates import (DiscountCurve, _affine_b, _broadcast_schedule, _on, _zcb_option_black)

__all__ = [
    "G2Params",
    "g2_bond",
    "g2_zcb_option",
    "g2_caplet",
    "g2_cap",
    "g2_swaption",
    "g2_joint_increment_moments",
    "g2_phi_integral",
    "g2_simulate",
]


class G2Params(NamedTuple):
    """G2++ parameters with the market curve embedded (phi is implicit:
    every pricer works off ``curve`` directly, so the curve is reproduced
    exactly and calibration only fits the five dynamical parameters)."""

    a: torch.Tensor
    b: torch.Tensor
    sigma: torch.Tensor
    eta: torch.Tensor
    rho: torch.Tensor
    curve: DiscountCurve

    def validate(self):
        for name in ("a", "b", "sigma", "eta"):
            if float(getattr(self, name)) <= 0:
                raise ValueError(f"{name} must be positive")
        if not -1.0 < float(self.rho) < 1.0:
            raise ValueError("rho must be in (-1, 1)")
        return self


def _dyn(p: G2Params, *xs):
    """(a, b, sigma, eta, rho) and ``xs`` as tensors on the curve's device
    in one dtype."""
    return _on(p.curve, p.a, p.b, p.sigma, p.eta, p.rho, *xs)


def _v_func(p: G2Params, tau):
    """V(t, t+tau): the integrated bond-volatility variance (B-M 4.10)."""
    a, b, sig, eta, rho, tau = _dyn(p, tau)
    ea, eb = torch.exp(-a * tau), torch.exp(-b * tau)
    v1 = (sig * sig / (a * a)) * (tau + (2.0 / a) * ea - (1.0 / (2.0 * a)) * ea * ea
                                  - 3.0 / (2.0 * a))
    v2 = (eta * eta / (b * b)) * (tau + (2.0 / b) * eb - (1.0 / (2.0 * b)) * eb * eb
                                  - 3.0 / (2.0 * b))
    v12 = (2.0 * rho * sig * eta / (a * b)) * (
        tau + (ea - 1.0) / a + (eb - 1.0) / b - (torch.exp(-(a + b) * tau) - 1.0) / (a + b))
    return v1 + v2 + v12


def g2_bond(params: G2Params, maturity, t=0.0, x=None, y=None):
    """P(t, T | x, y).  At ``t = 0`` (factors None) returns ``curve.df(T)``
    exactly."""
    curve = params.curve
    if x is None and y is None:
        return curve.df(maturity)
    T, t, x, y = _on(curve, maturity, t, x, y)
    tau = T - t
    lnA = (torch.log(curve.df(T) / curve.df(t))
           + 0.5 * (_v_func(params, tau) - _v_func(params, T) + _v_func(params, t)))
    return torch.exp(lnA - _affine_b(params.a, tau) * x - _affine_b(params.b, tau) * y)


def _sigma_p(params: G2Params, expiry, bond_maturity):
    """Lognormal stdev of P(T0, T1) seen from 0 (B-M 4.15)."""
    a, b, sig, eta, rho, T0, T1 = _dyn(params, expiry, bond_maturity)
    du = T1 - T0
    s2 = (sig * sig / (2.0 * a ** 3) * (1.0 - torch.exp(-a * du)) ** 2
          * (1.0 - torch.exp(-2.0 * a * T0))
          + eta * eta / (2.0 * b ** 3) * (1.0 - torch.exp(-b * du)) ** 2
          * (1.0 - torch.exp(-2.0 * b * T0))
          + 2.0 * rho * sig * eta / (a * b * (a + b))
          * (1.0 - torch.exp(-a * du)) * (1.0 - torch.exp(-b * du))
          * (1.0 - torch.exp(-(a + b) * T0)))
    return torch.sqrt(s2)


def g2_zcb_option(params: G2Params, strike, expiry, bond_maturity, is_call=True):
    """European option on a ZCB: the lognormal Black kernel shared with
    Hull-White (``rates._zcb_option_black``)."""
    curve = params.curve
    return _zcb_option_black(curve.df(expiry), curve.df(bond_maturity), strike,
                             _sigma_p(params, expiry, bond_maturity), is_call)


def g2_caplet(params: G2Params, strike_rate, start, end, notional=1.0):
    """Caplet by the standard ZCB-put static replication."""
    start, end, k = _on(params.curve, start, end, strike_rate)
    tau = end - start
    put = g2_zcb_option(params, 1.0 / (1.0 + tau * k), start, end, is_call=False)
    return notional * (1.0 + tau * k) * put


def g2_cap(params: G2Params, strike_rate, pay_times, notional=1.0):
    pt, = _on(params.curve, pay_times)
    return torch.sum(g2_caplet(params, strike_rate, pt[..., :-1], pt[..., 1:], notional),
                     dim=-1)


# ---------------------------------------------------------------------------
# European swaption: the Brigo-Mercurio 1D reduction


def _forward_measure_moments(params: G2Params, T0):
    """Mean/stdev/correlation of (x(T0), y(T0)) under the T0-forward
    measure (B-M 4.29-4.30): the drift correction -M^T(0,T0) per factor."""
    a, b, sig, eta, rho, T0 = _dyn(params, T0)
    ea, eb = torch.exp(-a * T0), torch.exp(-b * T0)
    eab = torch.exp(-(a + b) * T0)
    mx = -((sig * sig / (a * a) + rho * sig * eta / (a * b)) * (1.0 - ea)
           - sig * sig / (2.0 * a * a) * (1.0 - ea * ea)
           - rho * sig * eta / (b * (a + b)) * (1.0 - eab))
    my = -((eta * eta / (b * b) + rho * sig * eta / (a * b)) * (1.0 - eb)
           - eta * eta / (2.0 * b * b) * (1.0 - eb * eb)
           - rho * sig * eta / (a * (a + b)) * (1.0 - eab))
    sx = sig * torch.sqrt((1.0 - ea * ea) / (2.0 * a))
    sy = eta * torch.sqrt((1.0 - eb * eb) / (2.0 * b))
    rxy = rho * sig * eta * (1.0 - eab) / ((a + b) * sx * sy)
    return mx, my, sx, sy, rxy


@functools.lru_cache(maxsize=8)
def _hermegauss(n: int):
    """Probabilists' Gauss-Hermite nodes and weights / sqrt(2 pi), numpy
    on the host (cached)."""
    x, w = np.polynomial.hermite_e.hermegauss(n)
    return x, w / np.sqrt(2.0 * np.pi)


def _g2_swaption_impl(params, strike_rate, expiry, pay_times, *, payer, n_gh, n_newton):
    """Undiscounted-notional price; ``expiry``, ``strike_rate`` ``(...,)``
    and ``pay_times`` ``(..., n)`` already broadcast together."""
    curve = params.curve
    T0 = expiry
    taus = torch.diff(pay_times, dim=-1, prepend=T0[..., None])
    c = taus * strike_rate[..., None]
    c = torch.cat([c[..., :-1], c[..., -1:] + 1.0], dim=-1)

    du = pay_times - T0[..., None]
    Ba = _affine_b(params.a, du)
    Bb = _affine_b(params.b, du)
    # V and the curve read once each, on [du, pay dates, expiry] side by side
    n = du.shape[-1]
    v = _v_func(params, torch.cat([du, pay_times, T0[..., None]], dim=-1))
    dfs = curve.df(torch.cat([pay_times, T0[..., None]], dim=-1))
    lnA = (torch.log(dfs[..., :n] / dfs[..., n:])
           + 0.5 * (v[..., :n] - v[..., n:2 * n] + v[..., 2 * n:]))

    mx, my, sx, sy, rxy = (m[..., None] for m in _forward_measure_moments(params, T0))
    rbar = torch.sqrt(1.0 - rxy * rxy)

    # Gauss-Hermite over x ~ N(mx, sx) under Q^{T0}: nodes on axis -1 of
    # (..., n_gh), pay dates on axis -1 of (..., n_gh, n)
    gh_x, gh_w = (torch.as_tensor(v, dtype=T0.dtype, device=T0.device)
                  for v in _hermegauss(n_gh))
    xs = mx + sx * gh_x
    c_, lnA_, Ba_, Bb_ = (v[..., None, :] for v in (c, lnA, Ba, Bb))

    # critical boundary ybar(x): sum_i c_i A_i e^{-Ba_i x - Bb_i y} = 1,
    # strictly decreasing in y -> fixed-trip Newton from y = my, with the
    # derivative -sum_i Bb_i c_i A_i e^{...}; all trips but the last on
    # detached values, the last carrying the derivative in the inputs (as
    # rates._jamshidian_rate)
    def trip(yv, c_, base, Bb_):
        e = c_ * torch.exp(base - Bb_ * yv[..., None])
        return yv - (torch.sum(e, dim=-1) - 1.0) / -torch.sum(Bb_ * e, dim=-1)

    base = lnA_ - Ba_ * xs[..., None]
    yv = my.expand(xs.shape).detach()
    held = tuple(v.detach() for v in (c_, base, Bb_))
    for _ in range(n_newton - 1):
        yv = trip(yv, *held)
    if n_newton > 0:
        yv = trip(yv, c_, base, Bb_)

    # Payer exercises iff y > ybar(x) (bond leg cheap), receiver iff
    # y < ybar; conditioning y | x ~ N(mu_c, (sy rbar)^2) gives, per GH
    # node, Phi terms for the indicator and a completed-square exponential
    # for each e^{-Bb y} leg.  omega = +1 payer / -1 receiver.
    omega = 1.0 if payer else -1.0
    h1 = (yv - my) / (sy * rbar) - rxy * (xs - mx) / (sx * rbar)
    sy_, rbar_, rxy_, my_, mx_, sx_ = (v[..., None] for v in (sy, rbar, rxy, my, mx, sx))
    h2 = h1[..., None] + Bb_ * sy_ * rbar_
    lam = c_ * torch.exp(base)
    kap = -Bb_ * (my_ - 0.5 * rbar_ * rbar_ * sy_ * sy_ * Bb_
                  + rxy_ * sy_ * (xs[..., None] - mx_) / sx_)
    inner = norm_cdf(-omega * h1) - torch.sum(lam * torch.exp(kap) * norm_cdf(-omega * h2),
                                              dim=-1)
    return omega * curve.df(T0) * torch.sum(gh_w * inner, dim=-1)


def g2_swaption(params: G2Params, strike_rate, expiry, pay_times, *, notional=1.0,
                payer: bool = True, n_gh: int = 64, n_newton: int = 20):
    """European payer/receiver swaption (B-M formula 4.31): one
    Gauss-Hermite contraction over the first factor, the critical boundary
    solved by a node-vectorized fixed-trip Newton.  Pay dates on the last
    axis; ``expiry`` and ``strike_rate`` broadcast over the leading ones."""
    expiry, pt, k = _on(params.curve, expiry, pay_times, strike_rate, params.sigma)[:3]
    expiry, k = torch.broadcast_tensors(expiry, k)
    expiry, pt = _broadcast_schedule(expiry, pt)
    price = _g2_swaption_impl(params, k.expand(expiry.shape), expiry, pt, payer=payer,
                              n_gh=n_gh, n_newton=n_newton)
    return notional * price


# ---------------------------------------------------------------------------
# exact simulation: joint law of (x, y, int (x+y))


def g2_phi_integral(params: G2Params, t1, t2):
    """``int_{t1}^{t2} phi(s) ds`` in closed form.

    ``phi(t) = f(0,t) + sigma^2 Ba(t)^2/2 + eta^2 Bb(t)^2/2
    + rho sigma eta Ba(t) Bb(t)`` (B-M 4.12); each term integrates in
    elementary exponentials.
    """
    a, b, sig, eta, rho, t1, t2 = _dyn(params, t1, t2)
    curve = params.curve
    fwd = torch.log(curve.df(t1) / curve.df(t2))

    def int_sq(z, t):
        # int_0^t (1 - e^{-z s})^2 ds
        return (t + (2.0 / z) * (torch.exp(-z * t) - 1.0)
                - (1.0 / (2.0 * z)) * (torch.exp(-2.0 * z * t) - 1.0))

    def int_cross(t):
        # int_0^t (1 - e^{-a s})(1 - e^{-b s}) ds
        return (t + (torch.exp(-a * t) - 1.0) / a + (torch.exp(-b * t) - 1.0) / b
                - (torch.exp(-(a + b) * t) - 1.0) / (a + b))

    quad = (0.5 * sig * sig / (a * a) * (int_sq(a, t2) - int_sq(a, t1))
            + 0.5 * eta * eta / (b * b) * (int_sq(b, t2) - int_sq(b, t1))
            + rho * sig * eta / (a * b) * (int_cross(t2) - int_cross(t1)))
    return fwd + quad


def g2_joint_increment_moments(params: G2Params, dt):
    """Exact moments of ``(x', y', S)`` over a step of length ``dt`` given
    ``(x, y)``, where ``S = int (x+y) ds`` over the step.

    Returns ``(means, cov)``: ``means = (ex, ey, Ba, Bb)`` such that

        E[x'] = x ex,  E[y'] = y ey,  E[S] = x Ba + y Bb,

    and ``cov`` the 3x3 covariance of ``(x', y', S)`` on the last two axes
    (state-independent; leading axes follow ``dt``).
    """
    a, b, sig, eta, rho, dt = _dyn(params, dt)

    def one(z, s):
        e = torch.exp(-z * dt)
        B = (1.0 - e) / z
        v_x = s * s * (1.0 - e * e) / (2.0 * z)
        c_xI = (s * s / z) * (B - (1.0 - e * e) / (2.0 * z))
        v_I = (s * s / (z * z)) * (dt - 2.0 * B + (1.0 - e * e) / (2.0 * z))
        return e, B, v_x, c_xI, v_I

    ea, Ba, vxa, cxa, vIa = one(a, sig)
    eb, Bb, vxb, cxb, vIb = one(b, eta)

    ab = a + b
    eab = torch.exp(-ab * dt)
    # cross-factor second moments (driven by rho)
    c_xy = rho * sig * eta * (1.0 - eab) / ab                  # Cov(x', y')
    # Cov(x', I_b) = rho sig eta int e^{-a tau} Bb(tau) dtau
    c_x_Ib = rho * sig * eta / b * ((1.0 - torch.exp(-a * dt)) / a - (1.0 - eab) / ab)
    c_y_Ia = rho * sig * eta / a * ((1.0 - torch.exp(-b * dt)) / b - (1.0 - eab) / ab)
    # Cov(I_a, I_b) = rho sig eta int Ba(tau) Bb(tau) dtau
    c_IaIb = rho * sig * eta / (a * b) * (
        dt - (1.0 - torch.exp(-a * dt)) / a - (1.0 - torch.exp(-b * dt)) / b
        + (1.0 - eab) / ab)

    v_S = vIa + vIb + 2.0 * c_IaIb
    c_xS = cxa + c_x_Ib
    c_yS = cxb + c_y_Ia
    cov = torch.stack([torch.stack([vxa, c_xy, c_xS], -1),
                       torch.stack([c_xy, vxb, c_yS], -1),
                       torch.stack([c_xS, c_yS, v_S], -1)], -2)
    return (ea, eb, Ba, Bb), cov


def _g2_simulate_core(params: G2Params, ts, z):
    """The exact date-to-date law of ``(x, y, log D)`` on the normals ``z``
    (n_steps, 3, n_paths): each step's ``(x', y', S)`` is its conditional
    mean plus the Cholesky factor of the step covariance times ``z``."""
    dts = torch.diff(ts)
    (eas, ebs, Bas, Bbs), covs = g2_joint_increment_moments(params, dts)
    chols = torch.linalg.cholesky(covs + 1e-18 * torch.eye(3, dtype=ts.dtype,
                                                           device=ts.device))
    das = g2_phi_integral(params, ts[:-1], ts[1:])
    xv = yv = logd = torch.zeros(z.shape[-1], dtype=z.dtype, device=z.device)
    xs, ys, logds = [], [], []
    for k in range(dts.shape[0]):
        eps = chols[k] @ z[k]                          # (3, n_paths)
        S = xv * Bas[k] + yv * Bbs[k] + eps[2]
        xv = xv * eas[k] + eps[0]
        yv = yv * ebs[k] + eps[1]
        logd = logd - das[k] - S
        xs.append(xv)
        ys.append(yv)
        logds.append(logd)
    return torch.stack(xs), torch.stack(ys), torch.stack(logds)


def g2_simulate(params: G2Params, times, generator: torch.Generator, *,
                n_paths: int = 65536):
    """Exact path panel of ``(x, y, log D)`` at the given ``times``
    (strictly increasing, > 0), on the curve's device, from ``generator``
    (which must live there): ``D`` is the path's money-market discount
    ``e^{-int_0^t r ds}``, exact in distribution, so
    ``mean(e^{logD_j}) -> P(0, t_j)`` with pure MC error.  Philox and
    threefry streams differ: the paths match the reference only on the
    same normals (:func:`_g2_simulate_core`)."""
    times = _on(params.curve, times, params.sigma)[0]
    ts = torch.cat([torch.zeros(1, dtype=times.dtype, device=times.device), times])
    z = _normals(generator, (times.shape[0], 3, n_paths), times.dtype, times.device)
    return _g2_simulate_core(params, ts, z)
