"""Heston (1993) stochastic-volatility model (twin of
``pde_tpu/models/heston.py``).

* :func:`characteristic_function` — Heston (1993) Eq. 17 in the stable
  d/g/C/D form (reference: heston.cpp:37-92).
* :func:`price_carr_madan` — the damped Carr-Madan integrand summed on the
  exact reference grid (1024 points, du=0.01, alpha=0.75; heston.cpp:94-151),
  the whole (options x quadrature) tensor in one broadcast computation.
* The grouped pricers share the characteristic function across the
  strikes of each unique maturity; the corrected Gauss-Legendre rule
  reproduces the reference grid's rectangle sum from 70 nodes; plain
  Gauss-Legendre integrates the truncated integral itself.
* :func:`price_accurate` and its composite Gauss-Legendre twins
  :func:`price_accurate_gl` / :func:`price_accurate_gl_grouped` give the
  converged price (the Dupire surface differentiates these).
* :func:`price_fft` — the Carr-Madan FFT: one ``torch.fft.fft`` prices a
  whole log-strike grid.
* Implied vol of the Heston price, finite-difference Greeks with the
  reference's bumps (heston.cpp:169-218) and exact Greeks by autograd.

Parameters broadcast: a :class:`HestonParams` whose fields have shape
``(P, 1, 1)`` prices a population of P parameter sets at once, which is
how the calibration's DE stage prices a whole generation.  A params type
with the Heston fields plus a ``cf_reduced_extra(u, T, rdt, cdt)`` method
(an affine extension such as Bates' jumps) prices through every pricer
here: its factor multiplies the characteristic function.

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
from ..utils.profiling import span
from . import black_scholes as bs

__all__ = [
    "HestonParams",
    "characteristic_function",
    "price_carr_madan",
    "price_carr_madan_grouped",
    "price_carr_madan_gl",
    "price_carr_madan_gl_grouped",
    "price_gauss_legendre",
    "price_gauss_legendre_grouped",
    "group_maturities",
    "moment_explosion_time",
    "price_options",
    "price_with_greeks",
    "greeks_ad",
    "price_accurate",
    "price_accurate_gl",
    "price_accurate_gl_grouped",
    "price_accurate_grouped",
    "implied_volatility",
    "implied_volatility_grouped",
    "implied_volatility_surface",
    "price_fft",
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

    def validate(self) -> None:
        """Host-side validation (raises ValueError like the reference)."""
        k, t, s, r, v = (_host(x) for x in self)
        if np.any(k <= 0):
            raise ValueError("kappa must be positive")
        if np.any(t <= 0):
            raise ValueError("theta must be positive")
        if np.any(s <= 0):
            raise ValueError("sigma must be positive")
        if np.any(v <= 0):
            raise ValueError("v0 must be positive")
        if np.any(np.abs(r) >= 1):
            raise ValueError("rho must be in (-1, 1)")

    def to_array(self) -> torch.Tensor:
        """The fields broadcast together and stacked on a new last axis,
        on their tensors' device (the card for plain numbers)."""
        rdt, device = result_dtype(*self), device_of(*self)
        return torch.stack(torch.broadcast_tensors(
            *(to_tensor(x, rdt, device) for x in self)), dim=-1)

    @classmethod
    def from_array(cls, arr):
        return cls(arr[..., 0], arr[..., 1], arr[..., 2], arr[..., 3], arr[..., 4])


def _host(x) -> np.ndarray:
    """A field (number, array or tensor on any device) as a numpy array."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


_HESTON_FIELDS = ("kappa", "theta", "sigma", "rho", "v0")


def _params(params, rdt, device):
    """The five Heston fields, read by name: a params type that extends
    Heston (Bates' jump fields after them) carries more fields."""
    return tuple(to_tensor(getattr(params, k), rdt, device) for k in _HESTON_FIELDS)


def _extra(params, core, u, T, rdt, cdt):
    """``core`` times the params type's affine-extension factor
    ``cf_reduced_extra(u, T, rdt, cdt)`` where it has one.  The factor is 1
    at u = -i, so the forward, and with it the forward-moneyness pricing,
    is unchanged."""
    extra = getattr(params, "cf_reduced_extra", None)
    return core if extra is None else core * extra(u, T, rdt, cdt)


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
    phi = _extra(params, torch.exp(C + D * v0 + 1j * u * log_s + drift), u, T, rdt, cdt)
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
    return _extra(params, torch.exp(C + D * v0), u, T, rdt, cdt)


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


@functools.lru_cache(maxsize=None)
def _gl_rule(n_points: int, u_max: float):
    """Plain Gauss-Legendre nodes and weights on [0, u_max], float64 numpy."""
    nodes, wts = np.polynomial.legendre.leggauss(n_points)
    return 0.5 * u_max * (nodes + 1.0), 0.5 * u_max * wts


def price_gauss_legendre(
    params: HestonParams,
    strike,
    maturity,
    spot,
    rate=0.0,
    dividend=0.0,
    is_call=True,
    n_points: int = 64,
    u_max: float = N_QUADRATURE * DU,
    alpha: float = INTEGRATION_ALPHA,
):
    """European price by PLAIN Gauss-Legendre quadrature on [0, u_max]: the
    true truncated Carr-Madan integral, without the reference grid's
    dropped-endpoint offset (~0.16 absolute), so it differs from
    :func:`price_carr_madan` by that amount.  The uncorrected baseline of
    :func:`price_carr_madan_gl`."""
    strike, maturity, spot, rdt = _surface(strike, maturity, spot)
    v_np, w_np = _gl_rule(n_points, u_max)
    v = to_tensor(v_np, rdt, strike.device)
    w = to_tensor(w_np, rdt, strike.device)
    integral = _carr_madan_integrand_sum(
        params, strike, maturity, spot, rate, dividend, v, w, 1.0, alpha
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

    ``unique_T`` (..., M) and ``t_idx`` (..., N) may carry leading dims, U
    surfaces each with its own grouping; they broadcast against the
    parameters' leading dims as ``strikes`` (..., N) does.
    """
    rdt = strikes.dtype
    cdt = complex_dtype_for(rdt)
    u = v.to(cdt) - 1j * (alpha + 1.0)

    Tm = unique_T[..., None]  # (..., M, 1)
    cf = _cf_reduced(params, u, Tm, rdt, cdt)  # (..., M, n_u)
    cf = torch.where(Tm <= 0.0, torch.ones((), dtype=cdt, device=cf.device), cf)
    cfw = cf * (weights.to(cdt) / _denom(v, alpha, cdt))  # (..., M, n_u)

    # row gather per option; a grouping with leading dims (several
    # surfaces, each with its own maturities) gathers within its own rows
    t_idx = t_idx.long()
    rows = t_idx.reshape((1,) * (cfw.dim() - 1 - t_idx.dim()) + t_idx.shape + (1,))
    cfw_g = torch.take_along_dim(cfw, rows, dim=-2)  # (..., N, n_u)
    T = torch.take_along_dim(unique_T, t_idx, dim=-1)
    log_fk = torch.log(spot / strikes) + (rate - dividend) * T
    vl = v * log_fk[..., None]  # (..., N, n_u)
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


def price_gauss_legendre_grouped(
    params: HestonParams,
    strikes,
    t_idx,
    unique_T,
    spot,
    rate=0.0,
    dividend=0.0,
    is_call=True,
    n_points: int = 64,
    u_max: float = N_QUADRATURE * DU,
    alpha: float = INTEGRATION_ALPHA,
):
    """:func:`price_gauss_legendre` with the CF shared per unique maturity."""
    strikes, unique_T, spot, t_idx, rdt = _grouped_inputs(strikes, unique_T, spot, t_idx)
    v_np, w_np = _gl_rule(n_points, u_max)
    v = to_tensor(v_np, rdt, strikes.device)
    w = to_tensor(w_np, rdt, strikes.device)
    integral, T = _carr_madan_grouped_sum(
        params, strikes, t_idx, unique_T, spot, rate, dividend, v, w, 1.0, alpha
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


def price_carr_madan_gl(
    params: HestonParams,
    strike,
    maturity,
    spot,
    rate=0.0,
    dividend=0.0,
    is_call=True,
    n_points: int = 64,
    du: float = DU,
    alpha: float = INTEGRATION_ALPHA,
):
    """:func:`price_carr_madan` semantics at Gauss-Legendre cost, on the
    corrected rule (:func:`_gl_ref_rule`): the reference grid's rectangle
    sum, its dropped-endpoint bias included, to ~1e-9 from 70 instead of
    1023 integrand evaluations."""
    with span("pde_tpu_torch.heston.price_carr_madan_gl"):
        strike, maturity, spot, rdt = _surface(strike, maturity, spot)
        with span("pde_tpu_torch.heston.rule"):
            v_np, w_np = _gl_ref_rule(n_points, du, N_QUADRATURE * du)
            v = to_tensor(v_np, rdt, strike.device)
            w = to_tensor(w_np, rdt, strike.device)
        with span("pde_tpu_torch.heston.integrand"):
            integral = _carr_madan_integrand_sum(
                params, strike, maturity, spot, rate, dividend, v, w, 1.0, alpha
            )
        with span("pde_tpu_torch.heston.price"):
            return _price_from_integral(
                integral, strike, maturity, spot, rate, dividend, is_call, alpha, rdt
            )


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
    v, weights = _trapezoid(n_points, du, rdt, strike.device)
    integral = _carr_madan_integrand_sum(
        params, strike, maturity, spot, rate, dividend, v, weights, du, alpha
    )
    return _price_from_integral(
        integral, strike, maturity, spot, rate, dividend, is_call, alpha, rdt
    )


@functools.lru_cache(maxsize=None)
def _accurate_gl_rule(n_per_panel: int = 40,
                      edges: tuple = (0.0, 4.0, 12.0, 28.0, 60.0, 110.0,
                                      160.0, 204.8)):
    """Composite Gauss-Legendre rule for the CONVERGED Carr-Madan integral:
    7 geometrically widening panels of ``n_per_panel`` nodes on the same
    [0, 204.8] truncation as :func:`price_accurate`'s 8192-point trapezoid,
    at better accuracy (panel width capped near 50 so the deep-wing
    oscillations exp(i v ln(F/K)) stay resolved).  Returns float64 numpy
    (v, w)."""
    vs, ws = [], []
    nodes, wts = np.polynomial.legendre.leggauss(n_per_panel)
    for a, b in zip(edges[:-1], edges[1:]):
        vs.append(0.5 * (b - a) * (nodes + 1.0) + a)
        ws.append(0.5 * (b - a) * wts)
    return np.concatenate(vs), np.concatenate(ws)


def price_accurate_gl(
    params: HestonParams,
    strike,
    maturity,
    spot,
    rate=0.0,
    dividend=0.0,
    is_call=True,
    n_per_panel: int = 40,
    alpha: float = 1.25,
):
    """:func:`price_accurate` (converged pricing) on the composite GL rule
    (:func:`_accurate_gl_rule`): ~29x fewer integrand evaluations.
    Elementwise in (strike, maturity), so forward-mode AD with a ones
    tangent gives each point's own derivative."""
    strike, maturity, spot, rdt = _surface(strike, maturity, spot)
    v_np, w_np = _accurate_gl_rule(n_per_panel)
    v = to_tensor(v_np, rdt, strike.device)
    w = to_tensor(w_np, rdt, strike.device)
    integral = _carr_madan_integrand_sum(
        params, strike, maturity, spot, rate, dividend, v, w, 1.0, alpha
    )
    return _price_from_integral(
        integral, strike, maturity, spot, rate, dividend, is_call, alpha, rdt
    )


def price_accurate_gl_grouped(
    params: HestonParams,
    strikes,
    t_idx,
    unique_T,
    spot,
    rate=0.0,
    dividend=0.0,
    is_call=True,
    n_per_panel: int = 40,
    alpha: float = 1.25,
):
    """:func:`price_accurate_gl` with the CF shared per unique maturity."""
    strikes, unique_T, spot, t_idx, rdt = _grouped_inputs(strikes, unique_T, spot, t_idx)
    v_np, w_np = _accurate_gl_rule(n_per_panel)
    v = to_tensor(v_np, rdt, strikes.device)
    w = to_tensor(w_np, rdt, strikes.device)
    integral, T = _carr_madan_grouped_sum(
        params, strikes, t_idx, unique_T, spot, rate, dividend, v, w, 1.0, alpha
    )
    return _price_from_integral(
        integral, strikes, T, spot, rate, dividend, is_call, alpha, rdt
    )


def _trapezoid(n_points: int, du: float, rdt, device):
    """The converged pricers' trapezoid: n_points nodes du apart from 0,
    half weights at both ends."""
    v = torch.arange(n_points, dtype=rdt, device=device) * du
    weights = torch.ones((n_points,), dtype=rdt, device=device)
    weights[0] = weights[-1] = 0.5
    return v, weights


def price_accurate_grouped(
    params: HestonParams,
    strikes,
    t_idx,
    unique_T,
    spot,
    rate=0.0,
    dividend=0.0,
    is_call=True,
    n_points: int = 8192,
    du: float = 0.025,
    alpha: float = 1.25,
):
    """:func:`price_accurate` with the CF shared per unique maturity (flat
    chain vectors, e.g. IV scans over a quote list)."""
    strikes, unique_T, spot, t_idx, rdt = _grouped_inputs(strikes, unique_T, spot, t_idx)
    v, weights = _trapezoid(n_points, du, rdt, strikes.device)
    integral, T = _carr_madan_grouped_sum(
        params, strikes, t_idx, unique_T, spot, rate, dividend, v, weights, du, alpha
    )
    return _price_from_integral(
        integral, strikes, T, spot, rate, dividend, is_call, alpha, rdt
    )


def price_options(params, strikes, maturities, spot, rate=0.0, dividend=0.0,
                  is_call=True):
    """Batch pricing over a quote vector (the reference's OpenMP loop,
    heston.cpp:236-244, as one tensor program)."""
    return price_carr_madan(params, strikes, maturities, spot, rate, dividend,
                            is_call)


def _sqrt_v0(params, like: torch.Tensor) -> torch.Tensor:
    """sqrt(v0) in ``like``'s dtype and device: the Newton start of the
    Heston implied vols (heston.cpp:311-349)."""
    return torch.sqrt(to_tensor(params.v0, like.dtype, like.device))


def implied_volatility(params, strike, maturity, spot, rate=0.0, dividend=0.0,
                       is_call=True, accurate=False):
    """Black-Scholes implied vol of the Heston price.

    Matches HestonModel::implied_volatility (heston.cpp:311-349): Newton
    from vol0 = sqrt(v0), vega guard, clip [0.001, 5].  ``accurate=True``
    inverts the converged price (:func:`price_accurate_gl`) instead of the
    reference grid, whose truncation bias corrupts short-maturity IVs.
    """
    pricer = price_accurate_gl if accurate else price_carr_madan
    target = pricer(params, strike, maturity, spot, rate, dividend, is_call)
    return bs.implied_vol(target, spot, strike, rate, dividend, maturity, is_call,
                          init_vol=_sqrt_v0(params, target))


def implied_volatility_grouped(params, strikes, t_idx, unique_T, spot, rate=0.0,
                               dividend=0.0, is_call=True, accurate=False):
    """:func:`implied_volatility` for a flat (chain-ordered) quote list with
    the CF shared per unique maturity (:func:`group_maturities` first)."""
    pricer = price_accurate_gl_grouped if accurate else price_carr_madan_grouped
    target = pricer(params, strikes, t_idx, unique_T, spot, rate, dividend, is_call)
    strikes, unique_T, spot, t_idx, _ = _grouped_inputs(strikes, unique_T, spot, t_idx)
    T = unique_T[t_idx.long()]
    return bs.implied_vol(target, spot, strikes, rate, dividend, T, is_call,
                          init_vol=_sqrt_v0(params, target))


def implied_volatility_surface(params, strikes, maturities, spot, rate=0.0,
                               dividend=0.0, is_call=True, accurate=True):
    """IV on a (maturities x strikes) grid in one call: a tensor of shape
    (len(maturities), len(strikes)) (the reference builds it with a Python
    double loop, models/heston.py:313-343)."""
    rdt = result_dtype(strikes, maturities, spot)
    device = device_of(strikes, maturities, spot)
    K = to_tensor(strikes, rdt, device)[None, :]
    T = to_tensor(maturities, rdt, device)[:, None]
    return implied_volatility(params, K, T, spot, rate, dividend, is_call,
                              accurate=accurate)


def price_with_greeks(params, strike, maturity, spot, rate=0.0, dividend=0.0,
                      is_call=True):
    """Price plus finite-difference Greeks with the reference's stencils and
    bumps (heston.cpp:169-218): delta/gamma from +-0.1% spot bumps, rho from
    1bp rate bumps, theta one-sided 1/365, vega from +-0.001 bumps of v0."""

    def p(spot_, rate_, maturity_, v0_):
        return price_carr_madan(params._replace(v0=v0_), strike, maturity_, spot_,
                                rate_, dividend, is_call)

    eps_s = spot * 0.001
    eps_r = 0.0001
    eps_t = 1.0 / 365.0
    eps_v = 0.001
    v0 = params.v0

    price = p(spot, rate, maturity, v0)
    up = p(spot + eps_s, rate, maturity, v0)
    dn = p(spot - eps_s, rate, maturity, v0)
    T = to_tensor(maturity, price.dtype, price.device)
    theta_g = torch.where(T > eps_t, (p(spot, rate, maturity - eps_t, v0) - price) / eps_t,
                          torch.zeros_like(price))
    return {
        "price": price,
        "delta": (up - dn) / (2.0 * eps_s),
        "gamma": (up - 2.0 * price + dn) / (eps_s * eps_s),
        "vega": (p(spot, rate, maturity, v0 + eps_v)
                 - p(spot, rate, maturity, v0 - eps_v)) / (2.0 * eps_v),
        "theta": theta_g,
        "rho": (p(spot, rate + eps_r, maturity, v0)
                - p(spot, rate - eps_r, maturity, v0)) / (2.0 * eps_r),
    }


def greeks_ad(params, strike, maturity, spot, rate=0.0, dividend=0.0, is_call=True):
    """Exact Greeks by automatic differentiation of :func:`price_accurate`.

    Spot, rate, maturity and v0 enter the pricer as tensors that require
    grad; each Greek is the gradient of the summed price, so it has the
    shape of its own input (a scalar spot gives the book's delta).  Gamma
    differentiates delta's graph again.  Theta is -dP/dT, vega dP/dv0.
    """
    rdt = result_dtype(strike, maturity, spot, rate, params.v0)
    device = device_of(strike, maturity, spot, rate, params.v0)

    def leaf(x):
        return to_tensor(x, rdt, device).detach().requires_grad_(True)

    s, r, T, v0 = leaf(spot), leaf(rate), leaf(maturity), leaf(params.v0)
    with torch.enable_grad():
        price = price_accurate(params._replace(v0=v0), strike, T, s, r, dividend, is_call)
        delta, rho_g, dP_dT, vega_g = torch.autograd.grad(price.sum(), (s, r, T, v0),
                                                          create_graph=True)
        gamma = torch.autograd.grad(delta.sum(), s)[0]
    return {
        "price": price.detach(),
        "delta": delta.detach(),
        "gamma": gamma,
        "vega": vega_g.detach(),  # dV/dv0 (variance vega)
        "theta": -dP_dT.detach(),
        "rho": rho_g.detach(),
    }


def price_fft(params: HestonParams, maturity, spot, rate=0.0, dividend=0.0,
              n_fft: int = 4096, eta: float = 0.25, alpha: float = 1.5):
    """Carr-Madan FFT: calls on a whole log-strike grid from one
    ``torch.fft.fft`` of the damped characteristic function, with Simpson
    weights (O(eta^4)).  Returns ``(log_strikes, call_prices)``, the
    log-strikes centred on log(S0) and lam = 2 pi / (n_fft eta) apart."""
    rdt = result_dtype(maturity, spot)
    cdt = complex_dtype_for(rdt)
    device = device_of(maturity, spot)
    T = to_tensor(maturity, rdt, device)
    lam = 2.0 * math.pi / (n_fft * eta)  # log-strike spacing
    b = 0.5 * n_fft * lam  # log-strike half-width

    j = torch.arange(n_fft, dtype=rdt, device=device)
    v = j * eta
    u = v.to(cdt) - 1j * (alpha + 1.0)

    phi = characteristic_function(params, u, T, spot, rate, dividend)
    psi = torch.exp(-rate * T) * phi / _denom(v, alpha, cdt)

    # Simpson's weights (3 + (-1)^(j+1) - delta_{j0}) / 3, in the real dtype
    simpson = (3.0 + torch.pow(-1.0, j + 1.0)) / 3.0
    simpson[0] = 1.0 / 3.0

    log_s0 = torch.log(to_tensor(spot, rdt, device))
    k = -b + lam * j + log_s0  # log strikes centred at the spot
    x = torch.exp(1j * v.to(cdt) * (b - log_s0)) * psi * eta * simpson.to(cdt)
    calls = torch.exp(-alpha * k) / math.pi * torch.fft.fft(x).real
    return k, torch.clamp_min(calls, 0.0)
