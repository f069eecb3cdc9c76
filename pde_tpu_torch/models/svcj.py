"""SVCJ: stochastic volatility with correlated jumps in price AND variance
(Duffie-Pan-Singleton 2000), the Fourier half (twin of
``pde_tpu/models/svcj.py``).

Both state variables jump at the same Poisson arrivals:

    dS/S = (r - q - lam*kbar) dt + sqrt(v) dW_S + (e^{Z_x} - 1) dN
    dv   = kappa (theta - v) dt + sigma sqrt(v) dW_v + Z_v dN

with ``Z_v ~ Exp(mu_v)`` and ``Z_x | Z_v ~ N(mu_x + rho_j Z_v, sigma_x^2)``;
``kbar = exp(mu_x + sigma_x^2/2) / (1 - rho_j mu_v) - 1`` (needs
``rho_j * mu_v < 1``).

The v-jump enters the characteristic function through the Riccati
solution ``D(s)``, so its factor is the time-integrated jump transform

    lam * INT_0^T [ e^{i u mu_x - sigma_x^2 u^2 / 2}
                    / (1 - mu_v rho_j i u - mu_v D(s)) - 1 ] ds
    - i u lam kbar T

in closed form (:func:`_int_recip_affine`).  It plugs into the same
``cf_reduced_extra`` hook as Bates, so every pricer of
:mod:`pde_tpu_torch.models.heston` prices SVCJ.  The variance-swap hooks
``qv_mean_extra`` and ``qv_log_laplace_extra`` serve
:mod:`pde_tpu_torch.models.varswap`.

Monte Carlo overlays gamma-distributed variance jumps and conditionally
normal price jumps on the Andersen QE step of
:mod:`pde_tpu_torch.models.heston_mc`.

Reductions: ``mu_v = 0`` recovers Bates ``(lam, mu_x, sigma_x)``;
``lam = 0`` recovers Heston.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..core.precision import device_of, result_dtype, to_tensor
from . import heston as heston_model
from . import heston_mc
from .heston import HestonParams
from .heston_mc import MCPaths, _make_qe_step

__all__ = [
    "SVCJParams",
    "price_carr_madan_gl",
    "price_accurate",
    "price_accurate_grouped",
    "price_fft",
    "implied_volatility",
    "simulate_qe",
    "simulate_qe_paths",
    "simulate_qe_qv",
    "price_european_mc",
    "price_american_mc",
    "price_path_payoff_mc",
]


def _int_recip_affine(c, e, a, b, gamma, T):
    """Closed form of ``INT_0^T (c + e*y) / (a + b*y) ds`` with
    ``y = e^{-gamma s}`` (partial fractions in ``y``):

        (c/a) T + (e a - c b) / (a b gamma) * log((a + b) / (a + b e^{-gamma T}))

    ``b -> 0`` (e.g. the u = 0 node, where the Riccati D vanishes) is
    removable; the guarded branch takes the limit ``e (1 - y_T) / (a gamma)``.
    """
    y_T = torch.exp(-gamma * T)
    small = torch.abs(b) < 1e-12
    b_safe = torch.where(small, torch.ones_like(b), b)
    log_term = (e * a - c * b) / (a * b_safe * gamma) * torch.log(
        (a + b_safe) / (a + b_safe * y_T))
    limit = e * (1.0 - y_T) / (a * gamma)
    return c / a * T + torch.where(small, limit, log_term)


class SVCJParams(NamedTuple):
    """SVCJ parameters: the Heston five plus the co-jump five
    ``(lam, mu_x, sigma_x, mu_v, rho_j)``; numbers or tensors."""

    kappa: torch.Tensor
    theta: torch.Tensor
    sigma: torch.Tensor
    rho: torch.Tensor
    v0: torch.Tensor
    lam: torch.Tensor
    mu_x: torch.Tensor
    sigma_x: torch.Tensor
    mu_v: torch.Tensor
    rho_j: torch.Tensor

    def _on(self, dtype, device):
        """The fields as tensors of ``dtype`` on ``device``."""
        return SVCJParams(*(to_tensor(x, dtype, device) for x in self))

    # -- the affine-extension hook (heston._extra) --------------------------
    def cf_reduced_extra(self, u, T, rdt, cdt):
        """Time-integrated DPS jump transform, closed form.

        Recomputes the Heston Riccati intermediates (xi, d, g) as
        ``heston._cf_reduced`` does, writes ``D(s) = beta (1 - y)/(1 - g y)``
        with ``y = e^{-d s}``, and reduces ``INT 1/(ctil - mu_v D(s)) ds`` to
        :func:`_int_recip_affine` with ``(c, e, a, b) = (1, -g, ctil - mu_v
        beta, mu_v beta - ctil g)``.  At ``u = -i`` the exponent vanishes,
        so the factor is 1 and the forward is kept.
        """
        p = self._on(rdt, u.device)
        sigma2 = p.sigma * p.sigma
        xi = p.kappa - p.rho * p.sigma * 1j * u
        d = torch.sqrt(xi * xi + sigma2 * (1j * u + u * u))
        g = (xi - d) / (xi + d)
        beta = (xi - d) / sigma2

        ctil = 1.0 - p.mu_v * p.rho_j * 1j * u
        a = ctil - p.mu_v * beta
        b = p.mu_v * beta - ctil * g
        integral = _int_recip_affine(torch.ones_like(ctil), -g, a, b, d, T)

        phi_x = torch.exp(1j * u * p.mu_x - 0.5 * p.sigma_x * p.sigma_x * u * u)
        kbar = p.mean_jump()
        return torch.exp(p.lam * (phi_x * integral - T - 1j * u * kbar * T))

    # -- the variance-swap hooks (models/varswap.py) ------------------------
    def qv_mean_extra(self, T):
        """Jump contribution to the fair variance strike, per unit time: the
        price-jump QV rate ``lam E[Z_x^2]`` plus the v-jump feed-through
        ``(lam mu_v / kappa)(1 - (1 - e^{-kappa T})/(kappa T))``."""
        dt, device = result_dtype(T, *self), device_of(T, *self)
        T = to_tensor(T, dt, device)
        p = self._on(dt, device)
        ez2 = (p.sigma_x**2 + p.mu_x**2 + 2.0 * p.mu_x * p.rho_j * p.mu_v
               + 2.0 * (p.rho_j * p.mu_v) ** 2)
        kT = p.kappa * T
        feed = (p.lam * p.mu_v / p.kappa) * (1.0 - -torch.expm1(-kT) / kT)
        return p.lam * ez2 + feed

    def qv_log_laplace_extra(self, s, T):
        """log E-correction to the integrated-variance Laplace transform,
        the exact time-integrated joint jump transform

            lam * INT_0^T ( E[ e^{-s Z_x^2 - Z_v B(s, tau)} ] - 1 ) dtau

        with ``B(s, tau)`` the CIR Riccati solution.  The inner Gaussian
        expectation is closed form, ``Z_v`` is integrated by 32-node
        Gauss-Laguerre and ``tau`` by 64-node Gauss-Legendre.
        """
        dt = result_dtype(s, T, *self)
        device = device_of(s, T, *self)
        s = to_tensor(s, dt, device)
        T = to_tensor(T, dt, device)
        p = self._on(dt, device)
        gam = torch.sqrt(p.kappa * p.kappa + 2.0 * p.sigma * p.sigma * s)
        xl, wl = (to_tensor(v, dt, device) for v in _gauss_laguerre(32))
        xg, wg = (to_tensor(v, dt, device) for v in _gauss_legendre(64))
        # tau nodes on [0, T]; broadcast layout (..., n_tau, n_zv)
        tau = 0.5 * T[..., None] * (xg + 1.0)
        y = torch.exp(-gam[..., None] * tau)                    # (..., 64)
        B = (2.0 * s[..., None] * (1.0 - y)
             / ((gam[..., None] + p.kappa) + (gam[..., None] - p.kappa) * y))
        zv = p.mu_v * xl                                        # Exp(mu_v) nodes
        m = p.mu_x + p.rho_j * zv                               # (32,)
        q = 2.0 * s[..., None] * p.sigma_x**2                   # (..., 1)
        log_phi_x = -s[..., None] * m * m / (1.0 + q) - 0.5 * torch.log1p(q)
        # INT (E[...] - 1) dtau with the -1 inside the sums (the weights sum
        # to 2 and to 1): the reference's (integral - T) is a difference of
        # O(T) terms for an O(s) result, which costs float32 ~1e-4 of a
        # vol-swap strike
        inner = torch.sum(wl * torch.expm1(log_phi_x[..., None, :] - zv * B[..., :, None]),
                          dim=-1)                               # (..., 64)
        return p.lam * (0.5 * T * torch.sum(wg * inner, dim=-1))

    def qv_laplace_extra(self, s, T):
        return torch.exp(self.qv_log_laplace_extra(s, T))

    # -- reductions / checks -------------------------------------------------
    def heston(self) -> HestonParams:
        return HestonParams(self.kappa, self.theta, self.sigma, self.rho, self.v0)

    def mean_jump(self):
        """kbar = E[e^{Z_x}] - 1 over the co-jump mixture."""
        p = self._on(result_dtype(*self), device_of(*self))
        return torch.exp(p.mu_x + 0.5 * p.sigma_x**2) / (1.0 - p.rho_j * p.mu_v) - 1.0

    def feller_value(self):
        return 2.0 * self.kappa * self.theta - self.sigma**2

    def feller_satisfied(self):
        return self.feller_value() > 0

    def validate(self) -> None:
        if float(self.lam) < 0 or float(self.sigma_x) < 0 or float(self.mu_v) < 0:
            raise ValueError("lam, sigma_x, mu_v must be non-negative")
        if float(self.rho_j) * float(self.mu_v) >= 1.0:
            raise ValueError(
                "rho_j * mu_v must be < 1 for a finite jump compensator")
        if not -1.0 < float(self.rho) < 1.0:
            raise ValueError("rho must be in (-1, 1)")

    def to_array(self) -> torch.Tensor:
        """The fields stacked on a new FIRST axis (the reference's layout;
        Bates stacks on the last), on their tensors' device (the card for
        plain numbers)."""
        rdt, device = result_dtype(*self), device_of(*self)
        return torch.stack([to_tensor(v, rdt, device) for v in self])

    @classmethod
    def from_array(cls, arr):
        return cls(*arr)


@functools.lru_cache(maxsize=4)
def _gauss_hermite(n: int):
    """Gauss-Hermite nodes and weights, numpy on the host (cached)."""
    return np.polynomial.hermite.hermgauss(n)


@functools.lru_cache(maxsize=4)
def _gauss_laguerre(n: int):
    return np.polynomial.laguerre.laggauss(n)


@functools.lru_cache(maxsize=4)
def _gauss_legendre(n: int):
    return np.polynomial.legendre.leggauss(n)


# European pricing and IV: the Heston pricers take SVCJParams through the hook
price_carr_madan_gl = heston_model.price_carr_madan_gl
price_carr_madan_gl_grouped = heston_model.price_carr_madan_gl_grouped
price_accurate = heston_model.price_accurate
price_accurate_grouped = heston_model.price_accurate_grouped
price_fft = heston_model.price_fft
implied_volatility = heston_model.implied_volatility
implied_volatility_grouped = heston_model.implied_volatility_grouped


def _jump_overlay(k_t, n_paths, lam_dt, mu_x, sigma_x, mu_v, rho_j, dtype):
    """One step's co-jump draws: (x-jump total, v-jump total) per path.

    ``N ~ Poisson(lam dt)``; the summed v-jump is ``Gamma(N, mu_v)`` (a sum
    of N exponentials) and the summed x-jump given it is ``N mu_x + rho_j
    J_v + sqrt(N) sigma_x Z``, both exact for any N.
    """
    k_n, k_v, k_z = k_t.split(3)
    n = k_n.poisson(lam_dt, (n_paths,))
    has = n > 0
    gam = k_v.gamma(torch.where(has, n, 1.0))
    jv = torch.where(has, mu_v * gam, 0.0)
    z = k_z.normal((n_paths,), dtype, lam_dt.device)
    jx = n * mu_x + rho_j * jv + torch.sqrt(n) * sigma_x * z
    return jx, jv


def _qe_setup(params, spot, maturity, generator, rate, dividend, n_steps, n_paths, antithetic,
              martingale_correction, device):
    """The QE step (its drift carries the ``-lam kbar dt`` compensator), a
    step's co-jump overlay, dt, the ``n_steps`` step sources of
    ``generator`` and the start state ``(s0, ln_s0, v0)`` of an SVCJ
    simulation."""
    dtype = result_dtype(spot, maturity, params.kappa)
    device = device_of(spot, maturity, *params, default=device)
    xs = heston_mc._draws(generator, device).split(n_steps)
    p = params._on(dtype, device)
    _, _, dt, consts, theta, drift, s0, ln_s0, v0 = heston_mc._setup(
        p, spot, maturity, rate, dividend, n_steps, n_paths, antithetic, device,
        extra_drift=p.lam * p.mean_jump())
    E, c1, c2, k0_plain, k1, k2, k3, k4 = consts
    qe_step = _make_qe_step(
        E, c1, c2, theta, k0_plain, k1, k2, k3, k4, drift,
        n_paths // 2 if antithetic else n_paths, antithetic, martingale_correction, dtype,
    )
    lam_dt = p.lam * dt

    def jumps(k_jump):
        return _jump_overlay(k_jump, n_paths, lam_dt, p.mu_x, p.sigma_x, p.mu_v, p.rho_j,
                             dtype)

    return qe_step, jumps, dt, xs, s0, ln_s0, v0


def _cojump_step(qe_step, jumps):
    """The step ``(ln_s, v, k_t) -> (ln_s', v')``: QE diffusion, then the
    step's co-jumps in both the log-price and the variance."""

    def step(ln_s, v, k_t):
        k_diff, k_jump = k_t.split(2)
        ln_s_new, v_new = qe_step(ln_s, v, k_diff)
        jx, jv = jumps(k_jump)
        return ln_s_new + jx, v_new + jv

    return step


def simulate_qe(
    params: SVCJParams, spot, maturity, generator, *,
    n_steps: int = 64, n_paths: int = 65536, rate=0.0, dividend=0.0,
    antithetic: bool = True, martingale_correction: bool = True, device=None,
) -> MCPaths:
    """SVCJ paths: Andersen QE diffusion + per-step correlated co-jumps.

    The overlay bumps both the log-price and the variance inside the step
    loop, so the running average/max/min and every exotic estimator of
    :mod:`pde_tpu_torch.models.heston_mc` stay valid under co-jumps.
    ``generator`` is a ``torch.Generator`` on the path's device or a
    replay.
    """
    qe_step, jumps, _, xs, s0, ln_s0, v0 = _qe_setup(
        params, spot, maturity, generator, rate, dividend, n_steps, n_paths, antithetic,
        martingale_correction, device)
    return heston_mc._simulate_stats(_cojump_step(qe_step, jumps), xs, s0, ln_s0, v0, n_steps)


def simulate_qe_paths(
    params: SVCJParams, spot, maturity, generator, *,
    n_steps: int = 64, n_paths: int = 65536, rate=0.0, dividend=0.0,
    antithetic: bool = True, martingale_correction: bool = True, device=None,
):
    """Stored-path SVCJ simulation ``(S, v)`` of shape ``(n_steps,
    n_paths)``: feeds Longstaff-Schwartz exercise under co-jump risk through
    the ``simulate_paths_fn`` seam of :mod:`pde_tpu_torch.solvers.lsm`."""
    qe_step, jumps, _, xs, _, ln_s0, v0 = _qe_setup(
        params, spot, maturity, generator, rate, dividend, n_steps, n_paths, antithetic,
        martingale_correction, device)
    return heston_mc._simulate_stored(_cojump_step(qe_step, jumps), xs, ln_s0, v0)


def simulate_qe_qv(
    params: SVCJParams, spot, maturity, generator, *,
    n_steps: int = 64, n_paths: int = 65536, rate=0.0, dividend=0.0,
    antithetic: bool = True, martingale_correction: bool = True, device=None,
):
    """Per-path realized quadratic variation ``(int_0^T v dt, sum Z_x^2)``.

    The MC oracle of the variance-swap hooks with both co-jump legs live:
    the continuous leg is a trapezoid sum of the variance path (which the
    v-jumps feed), the jump leg the squared per-step price-jump total.  With
    at most one arrival per step almost surely, ``jx^2`` is the per-jump sum
    of squares up to an ``O((lam dt)^2)`` collision bias.
    """
    qe_step, jumps, dt, xs, _, ln_s, v = _qe_setup(
        params, spot, maturity, generator, rate, dividend, n_steps, n_paths, antithetic,
        martingale_correction, device)
    iv = qj = torch.zeros_like(ln_s)
    for k_t in xs:
        k_diff, k_jump = k_t.split(2)
        ln_s_new, v_new = qe_step(ln_s, v, k_diff)
        jx, jv = jumps(k_jump)
        # trapezoid on the diffused (pre-jump) endpoint: the jump lands at
        # the step boundary and feeds the NEXT interval's integrand
        iv = iv + 0.5 * (v + v_new) * dt
        qj = qj + jx * jx
        ln_s, v = ln_s_new + jx, v_new + jv
    return iv, qj


def price_european_mc(params: SVCJParams, strikes, maturity, spot, generator, **kwargs):
    """European vanillas under SVCJ via the QE + co-jump engine.  Returns
    ``(price, stderr)`` shaped like ``strikes``."""
    return heston_mc.price_european_mc(params, strikes, maturity, spot, generator,
                                       simulate_fn=simulate_qe, **kwargs)


def price_american_mc(params: SVCJParams, strike, maturity, spot, generator, **kwargs):
    """American vanilla under SVCJ via Longstaff-Schwartz on the co-jump
    paths; returns ``(price, stderr)``."""
    from ..solvers import lsm

    return lsm.price_american_lsm(params, strike, maturity, spot, generator,
                                  simulate_paths_fn=simulate_qe_paths, **kwargs)


def price_path_payoff_mc(params: SVCJParams, payoff_fn, spot, maturity, generator, **kwargs):
    """Generic path-payoff estimator under SVCJ (Asian/lookback/custom):
    heston_mc's estimator machinery over :func:`simulate_qe`."""
    return heston_mc.price_path_payoff_mc(params, payoff_fn, spot, maturity, generator,
                                          simulate_fn=simulate_qe, **kwargs)
