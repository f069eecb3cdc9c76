"""Heston (1993) stochastic-volatility model (twin of
``pde_tpu/models/heston.py``, the part the calibration slice uses).

* :func:`characteristic_function` — Heston (1993) Eq. 17 in the stable
  d/g/C/D form (reference: heston.cpp:37-92).
* :func:`price_carr_madan` — the damped Carr-Madan integrand summed on the
  exact reference grid (1024 points, du=0.01, alpha=0.75; heston.cpp:94-151),
  the whole (options x quadrature) tensor in one broadcast computation.
* The grouped pricers share the characteristic function across the
  strikes of each unique maturity; the corrected Gauss-Legendre rule
  reproduces the reference grid's rectangle sum from 70 nodes.

Parameters broadcast: a :class:`HestonParams` whose fields have shape
``(P, 1, 1)`` prices a population of P parameter sets at once, which is
how the calibration's DE stage prices a whole generation.

The integrand keeps the forward-moneyness form (see :func:`_cf_reduced`):
without it, complex64 on the GPU loses about five digits.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..core.precision import (complex_dtype_for, device_of, result_dtype,
                              to_tensor, where_flag)

__all__ = [
    "HestonParams",
    "characteristic_function",
    "price_carr_madan",
    "price_carr_madan_grouped",
    "price_carr_madan_gl_grouped",
    "price_accurate",
    "group_maturities",
    "moment_explosion_time",
    "price_options",
]

INTEGRATION_ALPHA = 0.75  # damping parameter (reference: heston.hpp)
N_QUADRATURE = 1024  # trapezoid points (heston.cpp:126)
DU = 0.01  # quadrature spacing (heston.cpp:127)


class HestonParams(NamedTuple):
    """Heston parameters (kappa, theta, sigma, rho, v0).

    Mirrors HestonParameters (src/cpp/models/heston.hpp:42-108); fields may
    be Python floats or tensors that broadcast against each other.
    """

    kappa: torch.Tensor
    theta: torch.Tensor
    sigma: torch.Tensor
    rho: torch.Tensor
    v0: torch.Tensor

    def feller_value(self):
        """2*kappa*theta - sigma^2 (>= 0 when the Feller condition holds)."""
        return 2.0 * self.kappa * self.theta - self.sigma**2

    def feller_satisfied(self):
        return self.feller_value() >= 0.0


def _params(params: HestonParams, rdt, device):
    return tuple(to_tensor(x, rdt, device) for x in params)


def characteristic_function(params: HestonParams, u, maturity, spot,
                            rate=0.0, dividend=0.0):
    """Heston characteristic function phi(u) of log-spot at maturity T.

    ``u`` may be complex (the Carr-Madan contour uses u = v - (alpha+1)i).
    Broadcasts over all arguments.  Reference: heston.cpp:37-92.
    """
    rdt = result_dtype(maturity, spot)
    cdt = complex_dtype_for(rdt)
    device = device_of(maturity, spot, u)
    u = to_tensor(u, cdt, device)
    T = to_tensor(maturity, rdt, device)
    log_s = torch.log(to_tensor(spot, rdt, device))
    kappa, th, sig, rho_, v0 = _params(params, rdt, device)

    sigma2 = sig * sig
    xi = kappa - rho_ * sig * 1j * u
    d = torch.sqrt(xi * xi + sigma2 * (1j * u + u * u))
    g = (xi - d) / (xi + d)

    exp_mdT = torch.exp(-d * T)
    C = (kappa * th / sigma2) * ((xi - d) * T - 2.0 * torch.log((1.0 - g * exp_mdT) / (1.0 - g)))
    D = ((xi - d) / sigma2) * ((1.0 - exp_mdT) / (1.0 - g * exp_mdT))

    drift = (rate - dividend) * 1j * u * T
    phi = torch.exp(C + D * v0 + 1j * u * log_s + drift)
    # T <= 0 edge case: phi = exp(i u log S0)   (heston.cpp:77-79)
    phi0 = torch.exp(1j * u * log_s)
    return torch.where(T <= 0.0, phi0, phi)


def _cf_reduced(params, u, T, rdt, cdt):
    """exp(C + D v0) — the CF without the iu*log-spot / drift phase terms.

    Splitting the phase out and folding it with the strike phase into one
    small forward-moneyness phase is what keeps the float32/complex64 path
    accurate: the two large, cancelling phases iu*ln(S0) and -iv*ln(K)
    never materialize.
    """
    kappa, th, sig, rho_, v0 = _params(params, rdt, T.device)

    sigma2 = sig * sig
    xi = kappa - rho_ * sig * 1j * u
    d = torch.sqrt(xi * xi + sigma2 * (1j * u + u * u))
    g = (xi - d) / (xi + d)
    exp_mdT = torch.exp(-d * T)
    C = (kappa * th / sigma2) * ((xi - d) * T - 2.0 * torch.log((1.0 - g * exp_mdT) / (1.0 - g)))
    D = ((xi - d) / sigma2) * ((1.0 - exp_mdT) / (1.0 - g * exp_mdT))
    return torch.exp(C + D * v0)


def _denom(v, alpha, cdt):
    """Carr-Madan denominator alpha^2 + alpha - v^2 + i (2 alpha + 1) v."""
    return torch.complex(alpha * alpha + alpha - v * v,
                         (2.0 * alpha + 1.0) * v).to(cdt)


def _carr_madan_integrand_sum(
    params, strike, maturity, spot, rate, dividend, v, weights, du, alpha
):
    """Weighted Carr-Madan sum in the forward-moneyness formulation.

    Returns du * sum_j w_j Re[ exp(C + D v0 + i v_j ln(F/K)) / denom(v_j) ]
    (mathematically the reference integrand, heston.cpp:109-122; the caller
    applies the prefactor).
    """
    rdt = result_dtype(strike, maturity, spot)
    cdt = complex_dtype_for(rdt)
    T = maturity[..., None]
    u = v.to(cdt) - 1j * (alpha + 1.0)

    log_fk = (torch.log(spot / strike) + (rate - dividend) * maturity)[..., None]

    cf = _cf_reduced(params, u, T, rdt, cdt)
    # T <= 0 edge: reduced CF -> 1 (C = D = 0), matching heston.cpp:77-79
    cf = torch.where(T <= 0.0, torch.ones((), dtype=cdt, device=cf.device), cf)
    phase = torch.exp(1j * v.to(cdt) * log_fk.to(cdt))
    integrand = (cf * phase / _denom(v, alpha, cdt)).real
    return du * torch.sum(weights * integrand, dim=-1)


def _carr_madan_integral(params, strike, maturity, spot, rate, dividend,
                         n_points, du, alpha):
    """The reference quadrature: j = 1..n_points-1, unit weights (the j=0
    term is zeroed by the v < 1e-10 guard, heston.cpp:110, and there is no
    right-endpoint half weight, heston.cpp:124-137)."""
    rdt = strike.dtype
    v = torch.arange(1, n_points, dtype=rdt, device=strike.device) * du
    weights = torch.ones((n_points - 1,), dtype=rdt, device=strike.device)
    return _carr_madan_integrand_sum(
        params, strike, maturity, spot, rate, dividend, v, weights, du, alpha
    )


def _surface(strike, maturity, spot):
    """Strike and maturity broadcast together, and the spot, as tensors of
    the result dtype on the inputs' device."""
    rdt = result_dtype(strike, maturity, spot)
    device = device_of(strike, maturity, spot)
    strike, maturity = torch.broadcast_tensors(
        to_tensor(strike, rdt, device), to_tensor(maturity, rdt, device))
    return strike, maturity, to_tensor(spot, rdt, device), rdt


def price_carr_madan(
    params: HestonParams,
    strike,
    maturity,
    spot,
    rate=0.0,
    dividend=0.0,
    is_call=True,
    n_points: int = N_QUADRATURE,
    du: float = DU,
    alpha: float = INTEGRATION_ALPHA,
):
    """European option price via the damped Carr-Madan integral.

    Semantics match HestonModel::price_option_integration
    (heston.cpp:94-151): price floored at zero, puts via put-call parity,
    intrinsic value at T <= 0.
    """
    strike, maturity, spot, rdt = _surface(strike, maturity, spot)
    integral = _carr_madan_integral(
        params, strike, maturity, spot, rate, dividend, n_points, du, alpha
    )
    return _price_from_integral(
        integral, strike, maturity, spot, rate, dividend, is_call, alpha, rdt
    )


def moment_explosion_time(params: HestonParams, moment: float) -> float:
    """Heston moment-explosion time T*(m): E[S_T^m] < infinity iff T < T*.

    Closed form from the Riccati ODE (Andersen & Piterbarg 2007).  Host-side
    scalar helper; Carr-Madan damping alpha needs T < T*(1 + alpha).
    """
    m = float(moment)
    kappa = float(params.kappa)
    sigma = float(params.sigma)
    rho = float(params.rho)
    if m * (m - 1.0) <= 0.0 or sigma <= 0.0:
        return float("inf")
    delta = 0.5 * m * (m - 1.0)
    beta = m * rho * sigma - kappa
    gamma = 0.5 * sigma * sigma
    disc = beta * beta - 4.0 * gamma * delta
    if disc >= 0.0:
        if beta <= 0.0:
            return float("inf")  # attracting root, or disc >= 0 needs delta <= 0
        rt = math.sqrt(disc)
        return float(math.log((beta + rt) / (beta - rt)) / rt)
    rt = math.sqrt(-disc)
    return float(2.0 / rt * (0.5 * math.pi - math.atan(beta / rt)))


def group_maturities(maturities, pad_to=None):
    """Host-side uniquing for the ``*_grouped`` pricers.

    Returns ``(unique_T, t_idx)`` as numpy arrays with
    ``unique_T[t_idx] == maturities``.  ``pad_to`` right-pads ``unique_T``
    (repeating the last value) so surfaces with different unique-maturity
    counts share one shape; the padded rows price nothing.
    """
    uT, inv = np.unique(np.asarray(maturities, dtype=np.float64), return_inverse=True)
    if pad_to is not None:
        if len(uT) > pad_to:
            raise ValueError(f"{len(uT)} unique maturities > pad_to={pad_to}")
        uT = np.concatenate([uT, np.full(pad_to - len(uT), uT[-1])])
    return uT, inv.reshape(np.shape(maturities)).astype(np.int32)


def _carr_madan_grouped_sum(
    params, strikes, t_idx, unique_T, spot, rate, dividend, v, weights, du, alpha
):
    """Weighted Carr-Madan sums with the characteristic function SHARED
    across strikes per unique maturity: M x n_u CF evaluations for an
    N-option surface with M maturities instead of N x n_u.  Identical math
    to :func:`_carr_madan_integrand_sum`; the per-u weight and denominator
    are folded into the CF rows before the gather.
    """
    rdt = strikes.dtype
    cdt = complex_dtype_for(rdt)
    u = v.to(cdt) - 1j * (alpha + 1.0)

    Tm = unique_T[:, None]  # (M, 1)
    cf = _cf_reduced(params, u, Tm, rdt, cdt)  # (..., M, n_u)
    cf = torch.where(Tm <= 0.0, torch.ones((), dtype=cdt, device=cf.device), cf)
    cfw = cf * (weights.to(cdt) / _denom(v, alpha, cdt))  # (..., M, n_u)

    t_idx = t_idx.long()
    cfw_g = cfw[..., t_idx, :]  # (..., N, n_u) row gather per option
    T = unique_T[t_idx]
    log_fk = torch.log(spot / strikes) + (rate - dividend) * T
    vl = v * log_fk[..., None]  # (N, n_u)
    # Re(cfw * e^{i v L}) = Re(cfw) cos(vL) - Im(cfw) sin(vL)
    integrand = cfw_g.real * torch.cos(vl) - cfw_g.imag * torch.sin(vl)
    return du * torch.sum(integrand, dim=-1), T


def _price_from_integral(
    integral, strikes, T, spot, rate, dividend, is_call, alpha, rdt
):
    """Carr-Madan integral -> option price: damping prefactor, zero floor,
    put-call parity, T<=0 intrinsic (heston.cpp:94-151).

    The prefactor is the forward-moneyness form
    ``e^{-alpha lnK} * F^{alpha+1} = K (F/K)^{alpha+1}``, the pair of the
    small-phase integrand.
    """
    discount = torch.exp(-rate * T)
    forward = spot * torch.exp((rate - dividend) * T)
    prefactor = strikes * (forward / strikes) ** (alpha + 1.0)
    call = torch.clamp_min((prefactor / math.pi) * discount * integral, 0.0)
    put = torch.clamp_min(call - spot * torch.exp(-dividend * T) + strikes * discount, 0.0)
    price = where_flag(is_call, call, put)
    intrinsic = where_flag(is_call, torch.clamp_min(spot - strikes, 0.0),
                           torch.clamp_min(strikes - spot, 0.0))
    return torch.where(T <= 0.0, intrinsic, price)


def _grouped_inputs(strikes, unique_T, spot, t_idx):
    rdt = result_dtype(strikes, unique_T, spot)
    device = device_of(strikes, unique_T, spot)
    return (to_tensor(strikes, rdt, device), to_tensor(unique_T, rdt, device),
            to_tensor(spot, rdt, device),
            torch.as_tensor(t_idx, device=device), rdt)


def price_carr_madan_grouped(
    params: HestonParams,
    strikes,
    t_idx,
    unique_T,
    spot,
    rate=0.0,
    dividend=0.0,
    is_call=True,
    n_points: int = N_QUADRATURE,
    du: float = DU,
    alpha: float = INTEGRATION_ALPHA,
):
    """:func:`price_carr_madan` with CF evaluations shared per unique
    maturity; ``unique_T``/``t_idx`` come from :func:`group_maturities`."""
    strikes, unique_T, spot, t_idx, rdt = _grouped_inputs(strikes, unique_T, spot, t_idx)
    v = torch.arange(1, n_points, dtype=rdt, device=strikes.device) * du
    weights = torch.ones((n_points - 1,), dtype=rdt, device=strikes.device)
    integral, T = _carr_madan_grouped_sum(
        params, strikes, t_idx, unique_T, spot, rate, dividend, v, weights, du, alpha
    )
    return _price_from_integral(
        integral, strikes, T, spot, rate, dividend, is_call, alpha, rdt
    )


@functools.lru_cache(maxsize=None)
def _gl_ref_rule(n_points: int, du: float, u_max: float, h: float = 0.005):
    """Quadrature rule reproducing the REFERENCE rectangle sum from
    ``n_points + 6`` integrand evaluations.

    The reference grid (heston.cpp:104-137) is the rectangle sum
    ``S = sum_{j=1}^{J-1} du * f(j*du)`` — the trapezoid over [0, u_max]
    minus its half-endpoints.  By Euler-Maclaurin

        S = integral_0^{u_max} f dv - du/2 * (f(0) + f(u_max))
            + du^2/12 * (f'(u_max) - f'(0)) + O(du^4 * f''')

    The integral is Gauss-Legendre; the endpoint values and derivatives use
    six extra nodes whose weights encode 3-point one-sided stencils.
    Returns float64 numpy ``(v, w)``; callers cast and pass ``du=1.0``.
    """
    nodes, wts = np.polynomial.legendre.leggauss(n_points)
    v = 0.5 * u_max * (nodes + 1.0)
    w = 0.5 * u_max * wts
    c = du * du / 12.0
    v_x = np.array([0.0, h, 2.0 * h, u_max - 2.0 * h, u_max - h, u_max])
    # -c * f'(0):  f'(0)  ~ (-3 f(0) + 4 f(h) - f(2h)) / (2h)
    w_lo = np.array([3.0, -4.0, 1.0]) * (c / (2.0 * h))
    # +c * f'(uN): f'(uN) ~ (f(uN-2h) - 4 f(uN-h) + 3 f(uN)) / (2h)
    w_hi = np.array([1.0, -4.0, 3.0]) * (c / (2.0 * h))
    w_x = np.concatenate([w_lo, w_hi])
    w_x[0] -= du / 2.0   # -du/2 * f(0)
    w_x[-1] -= du / 2.0  # -du/2 * f(u_max)
    return np.concatenate([v, v_x]), np.concatenate([w, w_x])


def price_carr_madan_gl_grouped(
    params: HestonParams,
    strikes,
    t_idx,
    unique_T,
    spot,
    rate=0.0,
    dividend=0.0,
    is_call=True,
    n_points: int = 64,
    du: float = DU,
    alpha: float = INTEGRATION_ALPHA,
):
    """:func:`price_carr_madan_grouped` semantics at Gauss-Legendre cost
    (:func:`_gl_ref_rule`): the reference grid's rectangle sum to ~1e-9
    from 70 instead of 1023 integrand evaluations.  Both calibration
    stages price through this."""
    strikes, unique_T, spot, t_idx, rdt = _grouped_inputs(strikes, unique_T, spot, t_idx)
    v_np, w_np = _gl_ref_rule(n_points, du, N_QUADRATURE * du)
    v = to_tensor(v_np, rdt, strikes.device)
    w = to_tensor(w_np, rdt, strikes.device)
    integral, T = _carr_madan_grouped_sum(
        params, strikes, t_idx, unique_T, spot, rate, dividend, v, w, 1.0, alpha
    )
    return _price_from_integral(
        integral, strikes, T, spot, rate, dividend, is_call, alpha, rdt
    )


def price_accurate(
    params: HestonParams,
    strike,
    maturity,
    spot,
    rate=0.0,
    dividend=0.0,
    is_call=True,
    n_points: int = 8192,
    du: float = 0.025,
    alpha: float = 1.25,
):
    """European price via a *converged* Carr-Madan quadrature.

    The reference grid (:func:`price_carr_madan`: 1024 x 0.01, v=0 term
    zeroed, truncated at v=10.24) sits ~0.2 below the true price at the
    money (2% of it); this proper trapezoid (half-weight endpoints, wide
    grid) agrees with independent truth to ~1e-6.  The PDE's accuracy gate
    compares against this.
    """
    strike, maturity, spot, rdt = _surface(strike, maturity, spot)
    v = torch.arange(n_points, dtype=rdt, device=strike.device) * du
    weights = torch.ones((n_points,), dtype=rdt, device=strike.device)
    weights[0] = weights[-1] = 0.5
    integral = _carr_madan_integrand_sum(
        params, strike, maturity, spot, rate, dividend, v, weights, du, alpha
    )
    return _price_from_integral(
        integral, strike, maturity, spot, rate, dividend, is_call, alpha, rdt
    )


def price_options(params, strikes, maturities, spot, rate=0.0, dividend=0.0,
                  is_call=True):
    """Batch pricing over a quote vector (the reference's OpenMP loop,
    heston.cpp:236-244, as one tensor program)."""
    return price_carr_madan(params, strikes, maturities, spot, rate, dividend,
                            is_call)
